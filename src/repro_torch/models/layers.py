"""Core neural layers of the port: norms, rotary embeddings, attention, MLPs.

Plain functions on tensors, as in :mod:`repro.models.layers`: ``init_*``
draws a parameter dict from a ``torch.Generator`` (float32, on the
generator's device), ``*_apply`` consumes it.  The weights keep the JAX
layouts: ``wq``/``wk``/``wv`` are (d, heads, head_dim), ``wo`` is
(heads, head_dim, d), MLP weights are (in, out), ``embed.table`` is
(vocab, d).  Prefill attention goes through the flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`) and RMSNorm through the
rmsnorm kernel (:func:`repro_torch.kernels.ops.rmsnorm`).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import ops

Params = dict[str, Any]

# ROADMAP items of the features this slice of the port does not carry yet.
ATTN_ITEM = "ROADMAP A2 (the rest of the attention layer: softcap, repeat_kv GQA, attention_decode)"
ZOO_ITEM = "ROADMAP A9 (rest of the zoo: vision and audio frontends)"


def _init(gen: torch.Generator, shape, scale=None) -> torch.Tensor:
    """Normal(0, 1)·scale, scale 1/sqrt(shape[0]) by default (as
    ``repro.models.layers._init``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    # Scaled in place: a full-width expert stack is 17.8 GB per weight.
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32).mul_(scale)


# --------------------------------------------------------------- norms
def init_norm(gen: torch.Generator, d: int, kind: str) -> Params:
    dev = gen.device
    if kind == "nonparam_ln":
        return {}
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, device=dev)}
    if kind == "layernorm":
        return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}
    raise ValueError(kind)


def norm_apply(params: Params, x: torch.Tensor, kind: str, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm goes through the rmsnorm kernel; the layernorms are plain."""
    if kind == "rmsnorm":
        return ops.rmsnorm(x, params["scale"], eps=eps)
    dtype = x.dtype
    x32 = x.float()
    if kind in ("layernorm", "nonparam_ln"):
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, correction=0)  # population variance
        y = (x32 - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * params["scale"] + params["bias"]
    else:
        raise ValueError(kind)
    return y.to(dtype)


# ---------------------------------------------------------------- rope
def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for ``positions`` (any leading shape)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta**exps)
    angles = positions.float()[..., None] * freqs  # (..., half)
    return torch.sin(angles), torch.cos(angles)


def rope_apply(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the head (not interleaved pairs).
    x: (..., seq, heads, head_dim); sin/cos broadcastable to
    (..., seq, head_dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ----------------------------------------------------------- attention
def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv: int, head_dim: int) -> Params:
    return {
        "wq": _init(gen, (d, n_heads, head_dim)),
        "wk": _init(gen, (d, n_kv, head_dim)),
        "wv": _init(gen, (d, n_kv, head_dim)),
        "wo": _init(gen, (n_heads, head_dim, d), scale=1.0 / math.sqrt(n_heads * head_dim)),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) @ w: (d, heads, hd) → (B, S, heads, hd)."""
    d, heads, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, heads * hd)).unflatten(-1, (heads, hd))


def attention_apply(
    params: Params,
    x: torch.Tensor,
    *,
    n_kv: int,
    rope_theta: float,
    sliding_window: int = 0,
    softcap: float = 0.0,
    repeat_kv: bool = False,
) -> torch.Tensor:
    """Full (prefill) causal GQA attention through the flash-attention
    kernel.  x: (B, S, d) → (B, S, d)."""
    if softcap > 0:
        raise NotImplementedError(f"attention logit softcap is not ported yet: {ATTN_ITEM}")
    if repeat_kv:
        raise NotImplementedError(f"repeat_kv GQA is not ported yet: {ATTN_ITEM}")
    b, s, _ = x.shape
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if k.shape[2] != n_kv:
        raise ValueError(f"wk has {k.shape[2]} KV heads, expected {n_kv}")
    sin, cos = rope_tables(torch.arange(s, device=x.device)[None, :], q.shape[-1], rope_theta)
    q = rope_apply(q, sin, cos)
    k = rope_apply(k, sin, cos)
    # (B, S, heads, hd) → (B, heads, S, hd) as strided views: the kernel
    # takes any stride but the head dimension's.
    ctx = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=sliding_window,
    )
    h, hd = q.shape[2], q.shape[3]
    ctx = ctx.transpose(1, 2).reshape(b, s, h * hd)
    return ctx @ params["wo"].to(x.dtype).reshape(h * hd, -1)


# ------------------------------------------------------------------ mlp
def init_mlp(gen: torch.Generator, d: int, ff: int, kind: str) -> Params:
    if kind == "none":
        return {}
    if kind == "swiglu":
        return {
            "w_gate": _init(gen, (d, ff)),
            "w_up": _init(gen, (d, ff)),
            "w_down": _init(gen, (ff, d), scale=1.0 / math.sqrt(ff)),
        }
    return {
        "w_up": _init(gen, (d, ff)),
        "w_down": _init(gen, (ff, d), scale=1.0 / math.sqrt(ff)),
    }


def mlp_apply(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    dtype = x.dtype
    if kind == "none":
        return torch.zeros_like(x)
    if kind == "swiglu":
        g = x @ params["w_gate"].to(dtype)
        u = x @ params["w_up"].to(dtype)
        return (F.silu(g) * u) @ params["w_down"].to(dtype)
    u = x @ params["w_up"].to(dtype)
    if kind == "gelu":
        u = F.gelu(u, approximate="tanh")  # jax.nn.gelu's default
    elif kind == "relu2":  # Nemotron-4 squared ReLU
        u = F.relu(u).square()
    else:
        raise ValueError(kind)
    return u @ params["w_down"].to(dtype)


# ------------------------------------------------------------ embedding
def init_embedding(gen: torch.Generator, vocab: int, d: int) -> Params:
    return {"table": _init(gen, (vocab, d), scale=1.0)}


def embed_apply(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    table = params["table"]
    vocab = table.shape[0]
    # JAX's gather semantics: a negative id counts from the end, and an id
    # out of range is clamped (the engine draws ids up to 999 whatever the
    # vocabulary).
    tokens = torch.where(tokens < 0, tokens + vocab, tokens).clamp(0, vocab - 1)
    # Gather, then cast: the same values as casting the whole table first.
    return table[tokens].to(dtype)


def unembed_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied head: x (..., d) against the embedding table (vocab, d)."""
    return x @ params["table"].to(x.dtype).T

