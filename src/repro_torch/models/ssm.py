"""State-space and recurrent cells of the port: Mamba (Hymba's parallel SSM
head), mLSTM and sLSTM (xLSTM's blocks).

The counterpart of :mod:`repro.models.ssm`, as plain functions on tensors:
``init_*`` draws the random leaves of a parameter dict from a
``torch.Generator`` (float32, on the generator's device; the constant
leaves are the reference's constants), ``*_apply`` runs a full sequence,
``init_*_cache`` makes a zeroed state on an explicit device (the card by
default) and ``*_decode`` takes one token and **updates the state in
place** (the reference returns a new one), returning it.

No kernel backs these cells in the reference (it computes them in
``jnp``), so they are torch operations here:

- Mamba keeps the reference's chunks and carry; inside a chunk the
  recurrence h_t = a_t·h_{t-1} + b_t is a log-depth doubling scan over the
  chunk axis with the combine ``(a1·a2, b1·a2 + b2)`` of the reference's
  ``lax.associative_scan``, in another association order.  Neither a
  cumulative product divided out (``a`` reaches e^(−16·dt) and the products
  underflow) nor a (chunk × chunk) decay matrix over (B, d, N) is formed.
- mLSTM is the reference's chunkwise form, stabiliser ``log(f + 1e-9)``
  included, with its state carried in float32.
- sLSTM's gates read h_{t-1}, so it steps through the sequence one token at
  a time, as the reference's ``lax.scan`` does.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import _init, _project
from .sharding import by_batch_and_heads, by_rows, by_rows_and_channels, linear

Params = dict[str, Any]


def _chunk_len(s: int, chunk: int) -> int:
    """``chunk`` capped at ``s`` and rounded down to a divisor of ``s``
    (``repro.models.ssm._chunked``)."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


# =====================================================================
# Mamba (selective SSM) — Hymba's parallel SSM head
# =====================================================================
def init_mamba(
    gen: torch.Generator, d: int, n_state: int, dt_rank: int = 16, conv_w: int = 4
) -> Params:
    dev = gen.device
    p = {
        "in_x": _init(gen, (d, d)),
        "in_z": _init(gen, (d, d)),
        "conv": _init(gen, (conv_w, d), scale=1.0 / math.sqrt(conv_w)),
        "w_b": _init(gen, (d, n_state)),
        "w_c": _init(gen, (d, n_state)),
        "w_dt_lo": _init(gen, (d, dt_rank)),
        "w_dt_hi": _init(gen, (dt_rank, d)),
        "out": _init(gen, (d, d)),
    }
    p["dt_bias"] = torch.zeros(d, device=dev)
    a_log = torch.log(torch.arange(1, n_state + 1, dtype=torch.float32, device=dev))
    p["a_log"] = a_log[None, :] * torch.ones((d, 1), device=dev)
    p["d_skip"] = torch.ones(d, device=dev)
    return p


def _scan_chunk(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t along dim 1 from h = 0, by
    doubling: after the step of offset k, element t holds the combination of
    elements max(0, t-2k+1)..t.  Returns (Π a, h) at every t."""
    k = 1
    while k < a.shape[1]:
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], b[:, :-k], a[:, k:])], 1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], 1)
        k *= 2
    return a, b


def _mamba_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, chunk: int) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t chunk by chunk.  a, b: (B, S, d, N); h0:
    (B, d, N).  Returns every h (B, S, d, N)."""
    s = a.shape[1]
    chunk = _chunk_len(s, chunk)
    outs = []
    h = h0
    for c in range(0, s, chunk):
        acum, bcum = _scan_chunk(a[:, c : c + chunk], b[:, c : c + chunk])
        h_t = acum * h[:, None] + bcum
        outs.append(h_t)
        h = h_t[:, -1]
    return torch.cat(outs, 1)


def _mamba_gates(params: Params, xc: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """dt, the float32 decay a = exp(−exp(a_log)·dt) and the B and C
    projections of the convolved input xc (..., d)."""
    dtype = xc.dtype
    dt = F.softplus(
        linear(linear(xc, params["w_dt_lo"].to(dtype)), params["w_dt_hi"].to(dtype))
        + params["dt_bias"].to(dtype)
    )
    a = torch.exp(-torch.exp(params["a_log"].float()) * dt[..., None].float())
    return dt, a, linear(xc, params["w_b"].to(dtype)), linear(xc, params["w_c"].to(dtype))


def _causal_conv(xb: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
    """The causal depthwise convolution of xb (B, S, d) with conv (w, d)."""
    s, w = xb.shape[1], conv.shape[0]
    pad = F.pad(xb, (0, 0, w - 1, 0))  # causal: w − 1 zero rows before the sequence
    return sum(pad[:, i : i + s] * conv[i] for i in range(w))


def mamba_apply(params: Params, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d)."""
    dtype = x.dtype
    xb = linear(x, params["in_x"].to(dtype))
    z = linear(x, params["in_z"].to(dtype))
    xc = F.silu(by_rows_and_channels(_causal_conv, xb, params["conv"].to(dtype),
                                     dims=((0, 2), (None, 1)), out_dims=(0, 2)))
    dt, a, bmat, cmat = _mamba_gates(params, xc)  # a: (B, S, d, N) float32
    bterm = ((dt * xc)[..., None] * bmat[:, :, None, :]).to(a.dtype)
    h0 = torch.zeros((x.shape[0], x.shape[2], bmat.shape[-1]), dtype=a.dtype, device=x.device)
    scan = functools.partial(_mamba_scan, chunk=chunk)
    h_all = by_rows_and_channels(scan, a, bterm, h0, dims=((0, 2), (0, 2), (0, 1)), out_dims=(0, 2))
    y = torch.einsum("bsdn,bsn->bsd", h_all.to(dtype), cmat)
    y = y + xc * params["d_skip"].to(dtype)
    y = y * F.silu(z)
    return linear(y, params["out"].to(dtype))


def init_mamba_cache(
    batch: int, d: int, n_state: int, conv_w: int = 4, dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> Params:
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, d, n_state), dtype=dtype, device=dev),
        "conv": torch.zeros((batch, conv_w - 1, d), dtype=dtype, device=dev),
    }


def mamba_decode(params: Params, x: torch.Tensor, cache: Params) -> tuple[torch.Tensor, Params]:
    """One step.  x: (B, 1, d) → (out (B, 1, d), cache updated in place)."""
    dtype = x.dtype
    xb = linear(x[:, 0], params["in_x"].to(dtype))
    z = linear(x[:, 0], params["in_z"].to(dtype))
    hist = torch.cat([cache["conv"].to(dtype), xb[:, None]], 1)  # (B, w, d)
    xc = F.silu(torch.einsum("bwd,wd->bd", hist, params["conv"].to(dtype)))
    dt, a, bmat, cmat = _mamba_gates(params, xc)  # a: (B, d, N)
    h = a * cache["h"].to(a.dtype) + ((dt * xc)[..., None] * bmat[:, None, :]).to(a.dtype)
    y = torch.einsum("bdn,bn->bd", h.to(dtype), cmat) + xc * params["d_skip"].to(dtype)
    y = y * F.silu(z)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return linear(y, params["out"].to(dtype))[:, None], cache


# =====================================================================
# mLSTM (xLSTM matrix-memory block) — chunkwise parallel
# =====================================================================
def init_mlstm(gen: torch.Generator, d: int, n_heads: int) -> Params:
    hd = d // n_heads
    return {
        "wq": _init(gen, (d, n_heads, hd)),
        "wk": _init(gen, (d, n_heads, hd)),
        "wv": _init(gen, (d, n_heads, hd)),
        "w_i": _init(gen, (d, n_heads)),
        "w_f": _init(gen, (d, n_heads)),
        "w_o": _init(gen, (d, d)),
        "out": _init(gen, (d, d)),
    }


def mlstm_apply(params: Params, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM.  x: (B, S, d) → (B, S, d).

    Per head: C_t = f_t·C_{t-1} + i_t·k_t v_tᵀ, n_t = f_t·n_{t-1} + i_t·k_t,
    h_t = (C_tᵀ q_t) / max(|n_t·q_t|, 1), with sigmoid gates."""
    s = x.shape[1]
    dtype = x.dtype
    q = _project(x, params["wq"]).transpose(1, 2)  # (B, H, S, hd)
    k = _project(x, params["wk"]).transpose(1, 2)
    v = _project(x, params["wv"]).transpose(1, 2)
    hd = q.shape[-1]
    # JAX promotes x.dtype / np.float32 to float32.
    k = k.float() / math.sqrt(hd)
    igate = torch.sigmoid(linear(x, params["w_i"].to(dtype))).transpose(1, 2)  # (B, H, S)
    fgate = torch.sigmoid(linear(x, params["w_f"].to(dtype))).transpose(1, 2)
    chunks = functools.partial(_mlstm_chunks, chunk=_chunk_len(s, chunk), dtype=dtype)
    h = by_batch_and_heads(chunks, q, k, v, igate, fgate, heads_out=2)  # (B, S, d)
    o = torch.sigmoid(linear(x, params["w_o"].to(dtype)))
    return linear(h * o, params["out"].to(dtype))


def _mlstm_chunks(q, k, v, igate, fgate, *, chunk: int, dtype) -> torch.Tensor:
    """The chunkwise recurrence over q, v (B, H, S, hd), the scaled float32
    k and the gates (B, H, S) → h (B, S, H·hd) in ``dtype``."""
    bsz, n_heads, s, hd = q.shape
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    c_state = torch.zeros((bsz, n_heads, hd, hd), dtype=torch.float32, device=q.device)
    n_state = torch.zeros((bsz, n_heads, hd), dtype=torch.float32, device=q.device)
    outs = []
    for c in range(0, s, chunk):
        sl = slice(c, c + chunk)
        lc = torch.cumsum(torch.log(fgate[:, :, sl].float() + 1e-9), -1)  # (B, H, chunk)
        ltot = lc[..., -1:]
        qf, kf, vf = q[:, :, sl].float(), k[:, :, sl], v[:, :, sl].float()
        iw = igate[:, :, sl].float()
        # intra-chunk: w_ij = (q_i·k_j)·exp(L_i − L_j)·i_j for j ≤ i
        scores = qf @ kf.transpose(-1, -2)
        decay = torch.exp(lc[..., :, None] - lc[..., None, :])
        w = torch.where(tri, scores * decay * iw[..., None, :], 0.0)
        # inter-chunk: exp(L_i)·q_i @ C_prev, and the normaliser likewise
        num = w @ vf + (qf * torch.exp(lc)[..., None]) @ c_state
        wn = torch.where(tri, decay * iw[..., None, :], 0.0)
        n_all = wn @ kf + torch.exp(lc)[..., None] * n_state[:, :, None, :]
        denom = torch.clamp_min(torch.abs((qf * n_all).sum(-1)), 1.0)
        outs.append((num / denom[..., None]).to(dtype))
        kdec = kf * torch.exp(ltot - lc)[..., None] * iw[..., None]
        c_state = torch.exp(ltot)[..., None] * c_state + kdec.transpose(-1, -2) @ vf
        n_state = torch.exp(ltot) * n_state + kdec.sum(2)
    return torch.cat(outs, 2).transpose(1, 2).reshape(bsz, s, n_heads * hd)


def _mlstm_cell(q, k, v, i, f, c, n):
    """One step of the cell: q, k, v (B, H, hd) float32, the gates (B, H),
    the state c (B, H, hd, hd) and n (B, H, hd) → (h, the new c, n)."""
    c = f[..., None, None] * c + i[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = f[..., None] * n + i[..., None] * k
    num = (q[..., None, :] @ c)[..., 0, :]
    denom = torch.clamp_min(torch.abs((q * n).sum(-1)), 1.0)
    return num / denom[..., None], c, n


def init_mlstm_cache(
    batch: int, d: int, n_heads: int, dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> Params:
    hd = d // n_heads
    dev = resolve_device(device)
    return {
        "c": torch.zeros((batch, n_heads, hd, hd), dtype=dtype, device=dev),
        "n": torch.zeros((batch, n_heads, hd), dtype=dtype, device=dev),
    }


def mlstm_decode(params: Params, x: torch.Tensor, cache: Params) -> tuple[torch.Tensor, Params]:
    """One step.  x: (B, 1, d) → (out (B, 1, d), cache updated in place)."""
    dtype = x.dtype
    xt = x[:, 0]
    q = _project(xt, params["wq"]).float()  # (B, H, hd)
    k = _project(xt, params["wk"]).float()
    v = _project(xt, params["wv"]).float()
    k = k / math.sqrt(q.shape[-1])
    i = torch.sigmoid(linear(xt, params["w_i"].to(dtype))).float()  # (B, H)
    f = torch.sigmoid(linear(xt, params["w_f"].to(dtype))).float()
    h, c, n = by_batch_and_heads(_mlstm_cell, q, k, v, i, f, cache["c"], cache["n"], n_out=3)
    h = h.reshape(xt.shape[0], -1).to(dtype)
    o = torch.sigmoid(linear(xt, params["w_o"].to(dtype)))
    cache["c"].copy_(c)
    cache["n"].copy_(n)
    return linear(h * o, params["out"].to(dtype))[:, None], cache


# =====================================================================
# sLSTM (xLSTM scalar-memory block) — sequential
# =====================================================================
def init_slstm(gen: torch.Generator, d: int, n_heads: int) -> Params:
    hd = d // n_heads
    return {
        # input projections of the gates i, f, z, o
        "w_in": _init(gen, (d, 4, d)),
        # block-diagonal recurrent weights, one (hd, hd) block a head: (4, H, hd, hd)
        "r": _init(gen, (4, n_heads, hd, hd), scale=1.0 / math.sqrt(hd)),
        "out": _init(gen, (d, d)),
    }


def _slstm_step(r: torch.Tensor, h, c, n, xg: torch.Tensor, n_heads: int):
    """One step of the recurrence.  r: (4, H, hd, hd) float32; h, c, n:
    (B, d) float32; xg: (4, B, d) the step's input gates."""
    bsz, d = h.shape
    hh = h.reshape(bsz, n_heads, d // n_heads)
    rec = torch.einsum("bhk,ghkl->gbhl", hh, r).reshape(4, bsz, d)
    g = xg + rec
    i = torch.sigmoid(g[0])
    f = torch.sigmoid(g[1])
    z = torch.tanh(g[2])
    o = torch.sigmoid(g[3])
    c2 = f * c + i * z
    n2 = torch.clamp_min(f * n + i, 1.0)
    return o * (c2 / n2), c2, n2


def _slstm_gates(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w_in (d, 4, d) → float32 (4, ..., d)."""
    xg = linear(x, params["w_in"].to(x.dtype))
    return xg.movedim(-2, 0).float()


def slstm_apply(params: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d), one step a token."""
    dtype = x.dtype
    xg = _slstm_gates(params, x).movedim(0, 1)  # (B, 4, S, d)
    scan = functools.partial(_slstm_scan, n_heads=n_heads)
    hs = by_rows(scan, (xg,), (params["r"].float(),))
    return linear(hs.to(dtype), params["out"].to(dtype))


def _slstm_scan(xg: torch.Tensor, r: torch.Tensor, *, n_heads: int) -> torch.Tensor:
    """The recurrence over the sequence: xg (B, 4, S, d) the input gates,
    r (4, H, hd, hd) float32 → every h (B, S, d) float32."""
    bsz, _, s, d = xg.shape
    h = c = n = torch.zeros((bsz, d), dtype=torch.float32, device=xg.device)
    hs = []
    for t in range(s):
        h, c, n = _slstm_step(r, h, c, n, xg[:, :, t].movedim(1, 0), n_heads)
        hs.append(h)
    return torch.stack(hs, 1)


def init_slstm_cache(
    batch: int, d: int, dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"
) -> Params:
    dev = resolve_device(device)
    return {name: torch.zeros((batch, d), dtype=dtype, device=dev) for name in ("h", "c", "n")}


def slstm_decode(
    params: Params, x: torch.Tensor, cache: Params, n_heads: int
) -> tuple[torch.Tensor, Params]:
    """One step.  x: (B, 1, d) → (out (B, 1, d), cache updated in place)."""
    dtype = x.dtype

    def step(h, c, n, xg, r):
        return _slstm_step(r, h, c, n, xg.movedim(1, 0), n_heads)

    h, c, n = by_rows(step, (cache["h"].float(), cache["c"].float(), cache["n"].float(),
                             _slstm_gates(params, x[:, 0]).movedim(0, 1)),
                      (params["r"].float(),), n_out=3)
    for name, new in (("h", h), ("c", c), ("n", n)):
        cache[name].copy_(new)
    return linear(h.to(dtype), params["out"].to(dtype))[:, None], cache
