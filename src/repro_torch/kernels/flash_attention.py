"""Binding and launch of the flash-attention kernel (``csrc/flash_attention.cu``).

The CUDA kernel replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``.  This module
checks what the kernel takes, allocates the output, launches on PyTorch's
current stream and counts the launches.  The plain version of the same
function is :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_ptr = ctypes.c_void_p


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_c_ptr] * 5 + [_c_int] * 6 + [_c_ll] * 9 + [_c_int, _c_int, ctypes.c_float, _c_ptr]
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
) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) on one CUDA device → (B, H, S, hd)
    in q's dtype.  Keys at or past ``lengths[b]`` are masked (``None``: all S);
    ``softcap > 0`` caps the scaled scores (tanh(s / cap) · cap) before the masks."""
    global launches
    check_inputs(q, k, v, lengths, softcap)
    devices = {t.device for t in (q, k, v)} | ({lengths.device} if lengths is not None else set())
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"all inputs must lie on one CUDA device; got {devices}")
    b, h, s, hd = q.shape
    out = torch.empty((b, h, s, hd), dtype=q.dtype, device=q.device)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            out.data_ptr(),
            DTYPES[q.dtype], b, h, k.shape[1], s, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
