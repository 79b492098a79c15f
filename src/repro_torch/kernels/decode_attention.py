"""Binding and launch of the decode-attention kernel (``csrc/decode_attention.cu``).

The CUDA kernel replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``.  This module
checks what the kernel takes, allocates the output, launches on PyTorch's
current stream and counts the launches.  The plain version of the same
function is :func:`repro_torch.kernels.ref.decode_attention_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 192, 512)
# Head size 512 (xLSTM-1.3B's token path) is instantiated only for one
# query head a KV head over float32 queries and cache, with no softcap.
WIDE_HEAD_DIM = 512
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (query, cache) storage types the kernel takes: one type for both, or
# float32 queries over a bfloat16 cache (the models' decode step).
PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16))

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)


@functools.cache
def _entry():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(q, k_cache, v_cache, valid_len, softcap: float = 0.0) -> None:
    """Raise on input the kernel does not take (any device)."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("q must be (B, H, hd) and the caches (B, KV, S, hd)")
    b, h, hd = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != hd:
        raise ValueError(
            f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not fit q {tuple(q.shape)}"
        )
    if kv == 0 or h % kv or s == 0:
        raise ValueError(f"bad shape: H={h}, KV={kv}, S={s}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported by the kernel; it takes {HEAD_DIMS}")
    if v_cache.dtype != k_cache.dtype or (q.dtype, k_cache.dtype) not in PAIRS:
        raise TypeError(
            f"(q, cache) types must be one of {PAIRS}; got "
            f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}"
        )
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("q and the caches must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q and the caches must start on a 16-byte boundary (vector loads)")
    if valid_len.shape != (b,) or valid_len.dtype != torch.int32 or not valid_len.is_contiguous():
        raise ValueError("valid_len must be a contiguous (B,) int32 tensor")
    if not softcap >= 0:
        raise ValueError(f"softcap must be >= 0 (0: none), got {softcap}")
    if hd == WIDE_HEAD_DIM and (h != kv or q.dtype != torch.float32
                                or k_cache.dtype != torch.float32 or softcap > 0):
        raise ValueError(
            f"head_dim {hd} is taken only with one query head a KV head, float32 queries and "
            f"cache and no softcap; got {h} heads on {kv}, {q.dtype}/{k_cache.dtype}, softcap {softcap}"
        )


def decode_attention_cuda(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q: (B, H, hd); caches (B, KV, S, hd); valid_len (B,) int32, all on one
    CUDA device → (B, H, hd) in q's dtype.  Rows with ``valid_len == 0``
    come out as zeros.  A bfloat16 cache under float32 queries is read as
    it is stored and computed on in float32.  ``softcap > 0`` caps the
    scaled scores (tanh(s / cap) · cap) before the mask."""
    global launches
    check_inputs(q, k_cache, v_cache, valid_len, softcap)
    _build.refuse_autograd("decode_attention", q, k_cache, v_cache)
    devices = {t.device for t in (q, k_cache, v_cache, valid_len)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"all inputs must lie on one CUDA device; got {devices}")
    b, h, hd = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    fn = _entry()
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_len.data_ptr(),
            out.data_ptr(), DTYPES[q.dtype], DTYPES[k_cache.dtype], b, h, kv, s, hd,
            float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
