"""Seeded weights, made by the benchmark on the device, and the program's
parameter tree built from them.

The weights are drawn from one ``torch.Generator`` seeded with ``--seed``,
in one large call a kind of leaf for all layers at once, in float32 (the
type they are served in).  The same seed on the same device gives the same
values, so the reference makes them again after the window instead of
reading anything the program held.

Products are normal(0, 1/fan_in) as the program's own init; the norms'
scales are drawn around the program's constant 1, so that every one of
them takes part in the comparison.
"""

from __future__ import annotations

import math

import torch

Weights = dict[str, torch.Tensor]


def make_weights(cfg: dict, seed: int, device: str | torch.device,
                 out: Weights | None = None) -> Weights:
    """Every weight of the configuration, stacked over layers: (L, ...) per
    kind, plus the embedding table, the final norm and the LM head.  With
    ``out`` (an earlier result), the values are drawn into its tensors."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    names = iter(_names(cfg))

    def draw(shape):
        name = next(names)
        if out is None:
            return torch.randn(shape, generator=gen, device=gen.device)
        return torch.randn(shape, generator=gen, device=gen.device, out=out[name])

    def _normal(shape, scale):
        return draw(shape).mul_(scale)

    def _around(shape, centre, spread):
        return draw(shape).mul_(spread).add_(centre)

    n, d, v = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    h, kv, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    w: Weights = {
        "embed": _normal((v, d), 1.0),
        "final_norm": _around((d,), 1.0, 0.1),
        "lm_head": _normal((d, v), 1.0 / math.sqrt(d)),
        "norm1": _around((n, d), 1.0, 0.1),
        "norm2": _around((n, d), 1.0, 0.1),
        "wq": _normal((n, d, h * hd), 1.0 / math.sqrt(d)),
        "wk": _normal((n, d, kv * hd), 1.0 / math.sqrt(d)),
        "wv": _normal((n, d, kv * hd), 1.0 / math.sqrt(d)),
        "wo": _normal((n, h * hd, d), 1.0 / math.sqrt(h * hd)),
        "w_gate": _normal((n, d, ff), 1.0 / math.sqrt(d)),
        "w_up": _normal((n, d, ff), 1.0 / math.sqrt(d)),
        "w_down": _normal((n, ff, d), 1.0 / math.sqrt(ff)),
    }
    return w


def _names(cfg: dict) -> list[str]:
    """The leaves in the order :func:`make_weights` draws them."""
    names = ["embed", "final_norm", "lm_head", "norm1", "norm2", "wq", "wk", "wv", "wo",
             "w_gate", "w_up", "w_down"]
    return names


def port_params(cfg: dict, w: Weights) -> dict:
    """The program's parameter tree (``repro_torch.models.Model``'s layout:
    head projections (d, heads, hd), wo (heads, hd, d), one dict a layer),
    as views of ``w``: nothing is copied."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    blocks = []
    for i in range(cfg["n_layers"]):
        b = {
            "norm1": {"scale": w["norm1"][i]},
            "attn": {
                "wq": w["wq"][i].view(d, h, hd),
                "wk": w["wk"][i].view(d, kv, hd),
                "wv": w["wv"][i].view(d, kv, hd),
                "wo": w["wo"][i].view(h, hd, d),
            },
            "norm2": {"scale": w["norm2"][i]},
            "mlp": {"w_gate": w["w_gate"][i], "w_up": w["w_up"][i], "w_down": w["w_down"][i]},
        }
        blocks.append(b)
    return {
        "embed": {"table": w["embed"]},
        "blocks": blocks,
        "final_norm": {"scale": w["final_norm"]},
        "lm_head": w["lm_head"],
    }
