"""The ``hymba`` family: Hymba's hybrid decoder (arXiv:2411.13676), meta
tokens in front of every prompt, attention ∥ Mamba in every layer, windowed
layers with the meta tokens visible and global ones, K/V shared between
consecutive windowed layers, a SwiGLU MLP and a head tied to the embedding
(Hymba-1.5B).  Its plain reference is ``orloj_bench/reference/hymba.py``,
whose ``windows``, ``kv_sources``, ``producers`` and ``mask`` this module
reads as the program's configuration sets them.

A served (k, s) batch runs k rows of ``n_meta_tokens`` + s positions
through every layer; the head takes the s prompt positions alone.  The
head is the tied table's transpose, which the GEMM kernel does not take:
``gemm_products`` leaves it out, ``batch_flops`` counts it.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import work
from ..reference import hymba as ref
from . import around, normal


def model_config(cfg: dict):
    """The program's ``HymbaConfig`` from the configuration's file; a
    program without it (``repro_torch/models/hymba.py``) cannot serve the
    family, and the run stops here."""
    try:
        from repro_torch.models import HymbaConfig
    except ImportError as e:
        raise SystemExit(f"the program has no HymbaConfig (src/repro_torch/models/hymba.py), "
                         f"which the hymba family needs: {e}") from e

    return HymbaConfig(
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
        ssm_state=cfg["ssm_state"],
        block_pattern=cfg["block_pattern"],
        dtype=cfg["dtype"],
        param_dtype=cfg["dtype"],
        tie_embeddings=True,
        remat=False,
        ssm_expand=cfg["ssm_expand"],
        dt_rank=cfg["dt_rank"],
        n_meta_tokens=cfg["n_meta_tokens"],
        global_layers=tuple(cfg["global_layers"]),
        kv_share=cfg["kv_share"],
    )


def _inner(cfg: dict) -> int:
    return cfg["ssm_expand"] * cfg["d_model"]


def leaves(cfg: dict) -> list[tuple]:
    """Every weight, stacked over layers (``wk``/``wv`` over the layers that
    compute K/V), plus the embedding table, the meta tokens and the final
    norm, in the order they are drawn.  Products are normal(0, 1/fan_in) as
    the program's own init, the convolution normal(0, 1/width); the norms'
    scales and D are drawn around the program's constant 1, ``a_log``
    around its log(1 … N), and ``dt_bias`` around −4, so that Δ sits near
    softplus(−4) ≈ 0.018, Mamba's initial range (0.001 … 0.1), and the
    state carries across some hundred positions."""
    n, d, v = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    h, kv, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    e, ns, r, width = _inner(cfg), cfg["ssm_state"], cfg["dt_rank"], cfg["conv_width"]
    p = len(ref.producers(cfg))

    def a_log(t):
        return t.mul_(0.1).add_(torch.log(torch.arange(1, ns + 1, dtype=t.dtype, device=t.device)))

    return [
        ("embed", (v, d), normal(1.0)),
        ("meta", (cfg["n_meta_tokens"], d), normal(1.0)),
        ("final_norm", (d,), around(1.0, 0.1)),
        ("norm1", (n, d), around(1.0, 0.1)),
        ("norm_attn", (n, d), around(1.0, 0.1)),
        ("norm_ssm", (n, d), around(1.0, 0.1)),
        ("norm2", (n, d), around(1.0, 0.1)),
        ("wq", (n, d, h * hd), normal(1.0 / math.sqrt(d))),
        ("wk", (p, d, kv * hd), normal(1.0 / math.sqrt(d))),
        ("wv", (p, d, kv * hd), normal(1.0 / math.sqrt(d))),
        ("wo", (n, h * hd, d), normal(1.0 / math.sqrt(h * hd))),
        ("in_x", (n, d, e), normal(1.0 / math.sqrt(d))),
        ("in_z", (n, d, e), normal(1.0 / math.sqrt(d))),
        ("conv", (n, width, e), normal(1.0 / math.sqrt(width))),
        ("w_b", (n, e, ns), normal(1.0 / math.sqrt(e))),
        ("w_c", (n, e, ns), normal(1.0 / math.sqrt(e))),
        ("w_dt_lo", (n, e, r), normal(1.0 / math.sqrt(e))),
        ("w_dt_hi", (n, r, e), normal(1.0 / math.sqrt(r))),
        ("dt_bias", (n, e), around(-4.0, 0.5)),
        ("a_log", (n, e, ns), a_log),
        ("d_skip", (n, e), around(1.0, 0.1)),
        ("out", (n, e, d), normal(1.0 / math.sqrt(e))),
        ("w_gate", (n, d, ff), normal(1.0 / math.sqrt(d))),
        ("w_up", (n, d, ff), normal(1.0 / math.sqrt(d))),
        ("w_down", (n, ff, d), normal(1.0 / math.sqrt(ff))),
    ]


MAMBA = ("in_x", "in_z", "conv", "w_b", "w_c", "w_dt_lo", "w_dt_hi", "dt_bias", "a_log", "d_skip",
         "out")


def port_params(cfg: dict, w: dict) -> dict:
    """The program's parameter tree (``repro_torch.models.hymba``'s layout:
    head projections (d, heads, hd), wo (heads, hd, d), no ``wk``/``wv`` on
    a layer that reuses K/V, one dict a layer), as views of ``w``."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    rows = {layer: row for row, layer in enumerate(ref.producers(cfg))}
    blocks = []
    for i in range(cfg["n_layers"]):
        attn = {"wq": w["wq"][i].view(d, h, hd), "wo": w["wo"][i].view(h, hd, d)}
        if i in rows:
            attn["wk"] = w["wk"][rows[i]].view(d, kv, hd)
            attn["wv"] = w["wv"][rows[i]].view(d, kv, hd)
        blocks.append({
            "norm1": {"scale": w["norm1"][i]},
            "attn": attn,
            "mamba": {k: w[k][i] for k in MAMBA},
            "norm_attn": {"scale": w["norm_attn"][i]},
            "norm_ssm": {"scale": w["norm_ssm"][i]},
            "norm2": {"scale": w["norm2"][i]},
            "mlp": {"w_gate": w["w_gate"][i], "w_up": w["w_up"][i], "w_down": w["w_down"][i]},
        })
    return {
        "embed": {"table": w["embed"]},
        "meta": w["meta"],
        "blocks": blocks,
        "final_norm": {"scale": w["final_norm"]},
    }


def gemm_products(cfg: dict, k: int, s: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of every weight product the GEMM kernel takes in one padded
    (k, s) batch, M = k·(n_meta_tokens + s) rows: a layer's q, its k and v
    where it computes them, o, the Mamba's in_x, in_z, Δ's two, B, C and
    out, and the MLP's gate, up and down.  The tied head is not one."""
    m, d, ff = k * (cfg["n_meta_tokens"] + s), cfg["d_model"], cfg["d_ff"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    e, ns, r = _inner(cfg), cfg["ssm_state"], cfg["dt_rank"]
    out = []
    for i, src in enumerate(ref.kv_sources(cfg)):
        out += [(m, d, q)] + ([(m, d, kv), (m, d, kv)] if src == i else []) + [(m, q, d)]
        out += [(m, d, e), (m, d, e), (m, e, r), (m, r, e), (m, e, ns), (m, e, ns), (m, e, d)]
        out += [(m, d, ff), (m, d, ff), (m, ff, d)]
    return out


@functools.lru_cache(maxsize=64)
def _pairs(t: int, window: int, prefix: int) -> int:
    return int(ref.mask(t, window, prefix, "cpu").sum())


def flash_layer_work(cfg: dict, i: int, k: int, s: int) -> tuple[int, int]:
    """(bytes, FLOPs) of layer i's flash forward at a padded (k, s) batch
    over n_meta_tokens + s positions: q, k, v read once and the output
    written once, and 4·hd FLOPs a query head for each (query, key) pair
    of the layer's mask (causal, its window, the meta tokens seen)."""
    t = cfg["n_meta_tokens"] + s
    elt, _ = work.dtype_of(cfg)
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    pairs = _pairs(t, ref.windows(cfg)[i], cfg["n_meta_tokens"])
    return elt * (2 * k * h * t * hd + 2 * k * kv * t * hd), 4 * hd * pairs * h * k


def flash_bound_s(cfg: dict, k: int, s: int) -> float:
    """Least seconds of the batch's flash forwards: each layer within its own
    window, the meta tokens included, FLOPs at the dtype's peak or bytes at
    HBM bandwidth, whichever is longer."""
    peak = work.dtype_of(cfg)[1]
    total = 0.0
    for i in range(cfg["n_layers"]):
        nbytes, flops = flash_layer_work(cfg, i, k, s)
        total += max(flops / peak, nbytes / work.HBM_BYTES_PER_S)
    return total


SCAN_FLOPS_PER_STATE = 6  # A·Δ, exp(·)·h + (Δx)·B (a multiply and a multiply-add), C·h


def scan_flops(cfg: dict, k: int, s: int) -> int:
    """The Mamba scans' FLOPs of one padded batch, all layers."""
    t = cfg["n_meta_tokens"] + s
    return cfg["n_layers"] * SCAN_FLOPS_PER_STATE * k * t * _inner(cfg) * cfg["ssm_state"]


def scan_bytes(cfg: dict, k: int, s: int) -> int:
    """The least bytes of one layer's scan: the convolved input, Δ and the
    gate's input (k·T·inner each) and B and C (k·T·N each) read once, y
    written once, at the dtype's bytes."""
    t = cfg["n_meta_tokens"] + s
    elt, _ = work.dtype_of(cfg)
    return elt * (4 * k * t * _inner(cfg) + 2 * k * t * cfg["ssm_state"])


def scan_bound_s(cfg: dict, k: int, s: int) -> float:
    """Least seconds of the batch's scans, all layers: their bytes at HBM
    bandwidth."""
    return cfg["n_layers"] * scan_bytes(cfg, k, s) / work.HBM_BYTES_PER_S


def batch_flops(cfg: dict, k: int, s: int) -> int:
    """FLOPs of one served padded (k, s) batch: every product the GEMM kernel
    takes, the tied head over the k·s prompt positions, every layer's
    attention and every scan."""
    products = sum(2 * m * kk * n for m, kk, n in gemm_products(cfg, k, s))
    head = 2 * k * s * cfg["d_model"] * cfg["vocab_size"]
    attn = sum(flash_layer_work(cfg, i, k, s)[1] for i in range(cfg["n_layers"]))
    return products + head + attn + scan_flops(cfg, k, s)
