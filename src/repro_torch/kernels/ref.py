"""Plain PyTorch versions of the port's kernels (the allclose references).

Same masking as :mod:`repro.kernels.ref`: masked scores are filled with
-1e30, the softmax runs in float32, and a row with no valid key gives 0
(not NaN, not a uniform average)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    lengths: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) → (B, H, S, hd)."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, s, hd)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k).float() / math.sqrt(hd)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    mask = mask[None].expand(b, s, s)
    if lengths is not None:
        mask = mask & (j[None] < lengths.to(q.device)[:, None, None])
    mask = mask[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows → zero output (not NaN)
    probs = torch.where(mask, probs, 0.0)
    out = torch.einsum("bkgst,bktd->bkgsd", probs.to(q.dtype), v)
    return out.reshape(b, h, s, hd)


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
) -> torch.Tensor:
    """q: (B, H, hd); k/v_cache: (B, KV, S, hd); valid_len: (B,) → (B, H, hd)."""
    b, h, hd = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k_cache).float() / math.sqrt(hd)
    valid = torch.arange(s, device=q.device)[None] < valid_len.to(q.device)[:, None]
    valid = valid[:, None, None]  # (B, 1, 1, S)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # empty cache rows (valid_len == 0) → zero output (not uniform/NaN)
    probs = torch.where(valid, probs, 0.0).to(q.dtype)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v_cache)
    return out.reshape(b, h, hd)
