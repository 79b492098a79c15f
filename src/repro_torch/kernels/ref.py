"""Plain PyTorch versions of the port's kernels (the allclose references).

The attention versions mask as :mod:`repro.kernels.ref` does: masked
scores are filled with -1e30, the softmax runs in float32, and a row with
no valid key gives 0 (not NaN, not a uniform average).  A softcap, where
given, is applied to the scaled scores before the mask, as
``repro.models.layers`` applies it: tanh(s / cap) · cap."""

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
    softcap: float = 0.0,
    prefix: int = 0,
) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) → (B, H, S, hd).  With a
    window, the keys below ``prefix`` stay visible to every query."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, s, hd)
    scores = _cap(torch.einsum("bkgsd,bktd->bkgst", qg, k).float() / math.sqrt(hd), softcap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= (j > i - window) | (j < prefix)
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
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q: (B, H, hd); k/v_cache: (B, KV, S, hd); valid_len: (B,) → (B, H, hd)
    in q's dtype.  A cache of another type than q (bfloat16 under float32
    queries) is read back to q's type, as the reference model reads its
    bf16 cache."""
    b, h, hd = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    qg = q.reshape(b, kv, h // kv, hd)
    scores = _cap(torch.einsum("bkgd,bktd->bkgt", qg, k_cache).float() / math.sqrt(hd), softcap)
    valid = torch.arange(s, device=q.device)[None] < valid_len.to(q.device)[:, None]
    valid = valid[:, None, None]  # (B, 1, 1, S)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # empty cache rows (valid_len == 0) → zero output (not uniform/NaN)
    probs = torch.where(valid, probs, 0.0).to(q.dtype)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v_cache)
    return out.reshape(b, h, hd)


def _cap(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    return torch.tanh(scores / softcap) * softcap if softcap > 0 else scores


def selective_scan_ref(x, dt, bm, cm, z, a_log, d_skip):
    """Mamba's scan one position at a time, float32: h_t = exp(−exp(a_log)·Δ_t)·h_{t−1}
    + Δ_t·x_t·B_t from h = 0, y_t = (C_t·h_t + D·x_t)·silu(z_t).  x, dt, z:
    (B, S, E); bm, cm: (B, S, N); a_log: (E, N); d_skip: (E,) → (y (B, S,
    E), the last state (B, E, N))."""
    b, s, e = x.shape
    a = -torch.exp(a_log.float())
    h = torch.zeros((b, e, a.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dv, xv = dt[:, t].float(), x[:, t].float()
        h = torch.exp(a * dv[..., None]) * h + (dv * xv)[..., None] * bm[:, t, None, :].float()
        ys.append((h * cm[:, t, None, :].float()).sum(-1) + d_skip.float() * xv)
    y = torch.stack(ys, 1) * torch.nn.functional.silu(z.float())
    return y.to(x.dtype), h


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (T, d); scale: (d,) → x·rsqrt(mean(x²) + eps)·scale, computed in
    float32, returned in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def moe_gating_ref(logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: (T, E) → (gates (T, k) float32, ids (T, k) int32).

    The arithmetic of the Pallas body: a float32 softmax divided out before
    any selection, then k passes of argmax (``torch.argmax`` returns the
    first maximum, so a tie goes to the lowest index) with the chosen entry
    set to -1 between passes, and the k gates renormalised by their sum
    (at least 1e-9).  ``torch.topk`` is not used: it promises no order on
    ties."""
    x = logits.float()
    p = torch.exp(x - x.max(-1, keepdim=True).values)
    work = p / p.sum(-1, keepdim=True)
    gsum = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    gates, ids = [], []
    for _ in range(top_k):
        best = torch.argmax(work, dim=-1, keepdim=True)
        val = work.gather(-1, best)[:, 0]
        gates.append(val)
        ids.append(best[:, 0].to(torch.int32))
        gsum = gsum + val
        work = work.scatter(-1, best, -1.0)
    g = torch.stack(gates, dim=-1) / torch.clamp_min(gsum, 1e-9)[:, None]
    return g, torch.stack(ids, dim=-1)
