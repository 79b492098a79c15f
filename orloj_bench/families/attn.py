"""The ``attn`` family: decoders of pre-norm blocks, each RoPE attention with
grouped KV heads (within a sliding window where the configuration gives
one) and a SwiGLU MLP, then RMSNorm and an untied LM head (GLM-4-9B).  Its
plain reference is ``orloj_bench/reference/attn.py``."""

from __future__ import annotations

import math

from .. import work
from . import around, normal


def model_config(cfg: dict):
    """The program's ``ModelConfig`` from the configuration's file."""
    from repro_torch.models import ModelConfig

    return ModelConfig(
        name=cfg["name"],
        arch_type=cfg["arch_type"],
        n_layers=cfg["n_layers"],
        d_model=cfg["d_model"],
        n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_kv_heads"],
        d_ff=cfg["d_ff"],
        vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"],
        rope_theta=cfg["rope_theta"],
        sliding_window=cfg["sliding_window"],
        norm="rmsnorm",
        mlp="swiglu",
        block_pattern=cfg["block_pattern"],
        dtype=cfg["dtype"],
        param_dtype=cfg["dtype"],
        remat=False,
    )


def leaves(cfg: dict) -> list[tuple]:
    """Every weight, stacked over layers: (L, ...) a kind, plus the embedding
    table, the final norm and the LM head, in the order they are drawn.
    Products are normal(0, 1/fan_in) as the program's own init; the norms'
    scales are drawn around the program's constant 1, so that every one of
    them takes part in the comparison."""
    n, d, v = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    h, kv, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    return [
        ("embed", (v, d), normal(1.0)),
        ("final_norm", (d,), around(1.0, 0.1)),
        ("lm_head", (d, v), normal(1.0 / math.sqrt(d))),
        ("norm1", (n, d), around(1.0, 0.1)),
        ("norm2", (n, d), around(1.0, 0.1)),
        ("wq", (n, d, h * hd), normal(1.0 / math.sqrt(d))),
        ("wk", (n, d, kv * hd), normal(1.0 / math.sqrt(d))),
        ("wv", (n, d, kv * hd), normal(1.0 / math.sqrt(d))),
        ("wo", (n, h * hd, d), normal(1.0 / math.sqrt(h * hd))),
        ("w_gate", (n, d, ff), normal(1.0 / math.sqrt(d))),
        ("w_up", (n, d, ff), normal(1.0 / math.sqrt(d))),
        ("w_down", (n, ff, d), normal(1.0 / math.sqrt(ff))),
    ]


def port_params(cfg: dict, w: dict) -> dict:
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


def linear_flops_per_token(cfg: dict) -> int:
    """FLOPs of one token through every layer's products and the LM head."""
    d, ff, hd = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    h, kv = cfg["n_heads"], cfg["n_kv_heads"]
    attn = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    mlp = 3 * 2 * d * ff
    return cfg["n_layers"] * (attn + mlp) + 2 * d * cfg["vocab_size"]


def batch_flops(cfg: dict, k: int, s: int) -> int:
    """FLOPs of one served padded (k, s) batch: every padded position runs
    the whole model, head included, as the card computes it."""
    _, attn = work.flash_layer_work(cfg, k, s)
    return k * s * linear_flops_per_token(cfg) + cfg["n_layers"] * attn


def flash_bound_s(cfg: dict, k: int, s: int) -> float:
    """Least seconds of the batch's flash forwards: every layer attends
    within the same window."""
    return cfg["n_layers"] * work.flash_layer_bound_s(cfg, k, s)


def gemm_products(cfg: dict, k: int, s: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of every weight product of one padded (k, s) batch, M = k·s
    rows: q, k, v, o, gate, up and down a layer, then the LM head."""
    m, d, ff = k * s, cfg["d_model"], cfg["d_ff"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    layer = [(m, d, q), (m, d, kv), (m, d, kv), (m, q, d), (m, d, ff), (m, d, ff), (m, ff, d)]
    return layer * cfg["n_layers"] + [(m, d, cfg["vocab_size"])]
