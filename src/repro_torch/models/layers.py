"""Core neural layers of the port: norms, rotary embeddings, attention, MLPs.

Plain functions on tensors, as in :mod:`repro.models.layers`: ``init_*``
draws a parameter dict from a ``torch.Generator`` (float32, on the
generator's device), ``*_apply`` consumes it.  The weights keep the JAX
layouts: ``wq``/``wk``/``wv`` are (d, heads, head_dim), ``wo`` is
(heads, head_dim, d), MLP weights are (in, out), ``embed.table`` is
(vocab, d).  Prefill attention goes through the flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`), the one-token decode
step through the decode-attention kernel
(:func:`repro_torch.kernels.ops.decode_attention`) and RMSNorm through the
rmsnorm kernel (:func:`repro_torch.kernels.ops.rmsnorm`).

The KV cache keeps the decode kernel's layout, ``(B, KV, S, head_dim)``
(the reference's is ``(B, S, KV, head_dim)``; :mod:`.convert` maps one to
the other), so that a step transposes nothing.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..device import resolve_device
from ..kernels import ops
from .sharding import embedding, linear, merge_heads, write_slot

Params = dict[str, Any]


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
    """x: (..., d) @ w: (d, heads, hd) → (..., heads, hd)."""
    return linear(x, w.to(x.dtype))


def attention_apply(
    params: Params,
    x: torch.Tensor,
    *,
    n_kv: int,
    rope_theta: float,
    sliding_window: int = 0,
    softcap: float = 0.0,
    repeat_kv: bool = False,
    prefix: int = 0,
    kv: dict | None = None,
) -> torch.Tensor:
    """Full (prefill) causal GQA attention through the flash-attention
    kernel.  x: (B, S, d) → (B, S, d).  With a window, the first
    ``prefix`` positions stay visible to every query (Hymba's meta tokens).

    ``kv`` carries K and V (after RoPE, (B, S, KV, hd)) between layers
    that share them: a layer with ``wk``/``wv`` leaves its own there, a
    layer without them attends with what its partner left.

    ``repeat_kv`` changes only how the reference shards its einsums: its
    ``jnp.repeat`` sends query head h to KV head h // (H / KV), which is the
    kernel's own GQA map, so both settings make the same kernel call."""
    del repeat_kv
    b, s, _ = x.shape
    own = "wk" in params
    q = _project(x, params["wq"])
    if own:
        k = _project(x, params["wk"])
        v = _project(x, params["wv"])
        if k.shape[2] != n_kv:
            raise ValueError(f"wk has {k.shape[2]} KV heads, expected {n_kv}")
    sin, cos = rope_tables(torch.arange(s, device=x.device)[None, :], q.shape[-1], rope_theta)
    q = rope_apply(q, sin, cos)
    if own:
        k = rope_apply(k, sin, cos)
        if kv is not None:
            kv.update(k=k, v=v)
    else:
        k, v = kv["k"], kv["v"]
    # (B, S, heads, hd) → (B, heads, S, hd) as strided views: the kernel
    # takes any stride but the head dimension's.
    ctx = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=sliding_window, softcap=softcap, prefix=prefix,
    )
    return merge_heads(ctx.transpose(1, 2), params["wo"].to(x.dtype))


def init_kv_cache(
    batch: int,
    n_kv: int,
    cache_len: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Params:
    """A zeroed KV cache in the decode kernel's layout (B, KV, S, head_dim),
    on the card unless the caller asks for the CPU."""
    shape = (batch, n_kv, cache_len, head_dim)
    dev = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


class DecodeSlot(NamedTuple):
    """Where one decode step writes and what it reads, the same for every
    layer whose cache has the same length: :func:`decode_slot` makes it once
    per step."""

    slot: torch.Tensor  # (1,) int64: the cache slot of this step's K and V
    valid_len: torch.Tensor  # (B,) int32: the slots every row attends
    sin: torch.Tensor  # (1, 1, head_dim / 2): the rotary tables at pos
    cos: torch.Tensor


def decode_slot(
    pos: int | torch.Tensor,
    batch: int,
    cache_len: int,
    *,
    head_dim: int,
    rope_theta: float,
    sliding_window: int = 0,
    device: str | torch.device,
    prefix: int = 0,
) -> DecodeSlot:
    """The slot and the attended length of a step at ``pos`` (an int or a
    0-d integer tensor, one position for every row, kept on the device: no
    sync).  With a sliding window the cache is a ring and the slot is
    ``pos mod S``, or, with a ``prefix`` (Hymba's meta tokens, kept in the
    first slots), ``prefix + (pos − prefix) mod (S − prefix)`` past it;
    else the slot is ``pos``, clamped to the last slot once ``pos`` passes
    it, as JAX's ``dynamic_update_slice`` clamps its start.  Every row
    attends its first ``min(pos + 1, S)`` slots: both of the reference's
    masks, since a softmax does not see the order of the ring."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=device, dtype=torch.long).reshape(())
    else:
        pos = torch.full((), pos, dtype=torch.long, device=device)
    if sliding_window > 0 and prefix > 0:
        slot = torch.where(pos < prefix, pos, prefix + (pos - prefix) % (cache_len - prefix))
    elif sliding_window > 0:
        slot = pos % cache_len
    else:
        slot = pos.clamp(0, cache_len - 1)
    valid_len = (pos + 1).clamp(0, cache_len).to(torch.int32).expand(batch).contiguous()
    sin, cos = rope_tables(pos.reshape(1, 1), head_dim, rope_theta)
    return DecodeSlot(slot.reshape(1), valid_len, sin, cos)


def attention_decode(
    params: Params,
    x: torch.Tensor,
    cache: Params,
    pos: int | torch.Tensor | DecodeSlot,
    *,
    n_kv: int,
    rope_theta: float,
    sliding_window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, Params]:
    """One-token decode with a KV cache, through the decode-attention
    kernel.  x: (B, 1, d); ``pos``: the position of every row (an int or a
    0-d integer tensor), or the :class:`DecodeSlot` that
    :func:`decode_slot` made of it for this cache's length.  Returns
    (out (B, 1, d), cache).

    **The cache is updated in place** and returned (the reference returns a
    new one): this step's K and V, rounded to the cache's type, go to the
    step's slot, and every row attends the step's valid length (see
    :func:`decode_slot`).  A layer without ``wk``/``wv`` (Hymba's second
    of a pair sharing K/V) writes nothing and attends over its partner's
    cache, which the partner has written in the same step."""
    b = x.shape[0]
    own = "wk" in params
    q = _project(x, params["wq"])
    if own:
        k = _project(x, params["wk"])
        v = _project(x, params["wv"])
        if k.shape[2] != n_kv:
            raise ValueError(f"wk has {k.shape[2]} KV heads, expected {n_kv}")
    at = pos if isinstance(pos, DecodeSlot) else decode_slot(
        pos, b, cache["k"].shape[2], head_dim=q.shape[-1], rope_theta=rope_theta,
        sliding_window=sliding_window, device=x.device,
    )
    q = rope_apply(q, at.sin, at.cos)
    if own:
        k = rope_apply(k, at.sin, at.cos)
        for name, new in (("k", k), ("v", v)):
            write_slot(cache[name], at.slot, new.transpose(1, 2).to(cache[name].dtype))
    ctx = ops.decode_attention(q[:, 0], cache["k"], cache["v"], at.valid_len, softcap=softcap)
    return merge_heads(ctx, params["wo"].to(x.dtype))[:, None], cache


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
        g = linear(x, params["w_gate"].to(dtype))
        u = linear(x, params["w_up"].to(dtype))
        return linear(F.silu(g) * u, params["w_down"].to(dtype))
    u = linear(x, params["w_up"].to(dtype))
    if kind == "gelu":
        u = F.gelu(u, approximate="tanh")  # jax.nn.gelu's default
    elif kind == "relu2":  # Nemotron-4 squared ReLU
        u = F.relu(u).square()
    else:
        raise ValueError(kind)
    return linear(u, params["w_down"].to(dtype))


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
    # A vocabulary-sharded DTensor table is looked up shard by shard.
    return embedding(table, tokens).to(dtype)


def unembed_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied head: x (..., d) against the embedding table (vocab, d).  The
    plain product: the table's transpose has strided rows, which the GEMM
    kernel cannot address, so it is no weight product of the kernel's.  On
    DTensors it is placed as :func:`.sharding.linear` places a weight."""
    w = params["table"].to(x.dtype).T
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return linear(x, w)
    return x @ w

