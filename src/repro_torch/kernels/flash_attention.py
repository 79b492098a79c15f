"""Binding and launch of the flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its backward (``csrc/flash_attention_bwd.cu``).

The forward replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``; the backward has
no TPU counterpart (the JAX trainer differentiates einsums).  This module
checks what the kernels take, allocates their outputs, launches on
PyTorch's current stream and counts the launches.  The plain version of
the forward is :func:`repro_torch.kernels.ref.flash_attention_ref`; that of
the backward is autograd through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 192)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Keys a dK/dV block of the backward owns, by head size: ``Cfg<T, HD>::kRows``
# of ``csrc/flash_attention_bwd.cu`` (8 warps of 16 rows at 128, else 4).
KEY_ROWS = {16: 64, 32: 64, 64: 64, 128: 128, 192: 64}

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)
backward_launches = 0  # the same for the backward

_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_ptr = ctypes.c_void_p


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_c_ptr] * 6 + [_c_int] * 6 + [_c_ll] * 9 + [_c_int, _c_int, ctypes.c_float, _c_ptr]
    fn.restype = _c_int
    return fn


@functools.cache
def _backward_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [_c_ptr] * 12 + [_c_int] * 8 + [ctypes.c_float, _c_int, _c_ptr]
    fn.restype = _c_int
    return fn


def check_inputs(q, k, v, lengths, softcap: float = 0.0) -> None:
    """Raise on input the kernel does not take (any device)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, hd) and (B, KV, S, hd)")
    b, h, s, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != s or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    kv = k.shape[1]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported by the kernel; it takes {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q, k, v must be contiguous")
    # The kernel copies rows with 16-byte cp.async: every row of q, k, v
    # must start on a 16-byte boundary.
    for t in (q, k, v):
        steps = [st * t.element_size() for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st % 16 for st in steps):
            raise ValueError("every row of q, k, v must start on a 16-byte boundary (cp.async)")
    if lengths is not None:
        if lengths.shape != (b,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
            raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    if not softcap >= 0:
        raise ValueError(f"softcap must be >= 0 (0: none), got {softcap}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) on one CUDA device → (B, H, S, hd)
    in q's dtype.  Keys at or past ``lengths[b]`` are masked (``None``: all S);
    ``softcap > 0`` caps the scaled scores (tanh(s / cap) · cap) before the masks.
    With ``return_lse`` also each row's log-sum-exp of its scores, (B, H, S)
    float32, -inf for a row with no valid key: what the backward reads."""
    global launches
    check_inputs(q, k, v, lengths, softcap)
    _build.refuse_autograd("flash_attention", q, k, v)
    _check_device(q, k, v, lengths)
    b, h, s, hd = q.shape
    out = torch.empty((b, h, s, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            DTYPES[q.dtype], b, h, k.shape[1], s, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return (out, lse) if return_lse else out


def _check_device(*tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"all inputs must lie on one CUDA device; got {devices}")


def backward_splits(b: int, h: int, kv: int, s: int, hd: int, sms: int) -> int:
    """How many dK/dV blocks share a GQA group's query heads: 1 for a group
    of 1 or where the (KV head, batch row, key tile) blocks already number
    two a multiprocessor; else the smallest divisor of the group that brings
    them there, or the whole group (one head a block) if none does."""
    group = h // kv
    blocks = b * kv * -(-s // KEY_ROWS[hd])
    if group == 1 or blocks >= 2 * sms:
        return 1
    return next((d for d in range(2, group) if group % d == 0 and blocks * d >= 2 * sms), group)


def backward_scratch_shape(b: int, h: int, kv: int, s: int, hd: int, splits: int) -> tuple[int, ...]:
    """The float32 dK/dV partials of a split group, (2, splits, B, KV, S, hd),
    which the backward's last pass adds in split order; (0,) with one split."""
    return (2, splits, b, kv, s, hd) if splits > 1 else (0,)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (the backward's
    vector loads), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_backward_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_attention_cuda` at (q, k, v,
    lengths, causal, window, softcap), from its output ``out``, its
    ``lse`` (``return_lse=True``) and the output's gradient ``dout``; each
    in its input's dtype and shape, contiguous."""
    global backward_launches
    check_inputs(q, k, v, lengths, softcap)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} / dout {tuple(dout.shape)} do not fit q {tuple(q.shape)}")
    b, h, s, hd = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {s}) float32; got {tuple(lse.shape)} {lse.dtype}")
    _check_device(q, k, v, out, dout, lse, lengths)
    q, k, v, out, lse = (_aligned(t) for t in (q, k, v, out, lse))
    dout = _aligned(dout.to(q.dtype))
    kv = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    splits = backward_splits(b, h, kv, s, hd, _build.sm_count(q.device))
    stats = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)  # L·log2(e), rowsum(dO∘O)
    partial = torch.empty(backward_scratch_shape(b, h, kv, s, hd, splits), dtype=torch.float32,
                          device=q.device)
    fn = _backward_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), lengths.data_ptr() if lengths is not None else None,
            stats.data_ptr(), partial.data_ptr() if splits > 1 else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            DTYPES[q.dtype], b, h, kv, s, hd, int(causal), int(window), float(softcap), splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: cudaError {err}")
    backward_launches += 1
    return dq, dk, dv
