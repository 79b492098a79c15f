"""Binding and launch of the RMSNorm kernel (``csrc/rmsnorm.cu``).

The CUDA kernel replaces the Pallas TPU kernel
``repro.kernels.rmsnorm.rmsnorm_pallas``.  This module checks what the
kernel takes, allocates the output, launches on PyTorch's current stream
and counts the launches.  The plain version of the same function is
:func:`repro_torch.kernels.ref.rmsnorm_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)


@functools.cache
def _entry():
    fn = _build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(x, scale) -> None:
    """Raise on input the kernel does not take (any device)."""
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"x must be a non-empty (T, d) tensor; got {tuple(x.shape)}")
    if scale.shape != (x.shape[1],):
        raise ValueError(f"scale {tuple(scale.shape)} does not fit x {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {list(DTYPES)}; got {x.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32; got {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (T, d) float32 or bfloat16; scale: (d,) float32, both on one CUDA
    device → (T, d) in x's dtype."""
    global launches
    check_inputs(x, scale)
    _build.refuse_autograd("rmsnorm", x, scale)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"x and scale must lie on one CUDA device; got {x.device}, {scale.device}")
    t, d = x.shape
    out = torch.empty_like(x)
    # 4-wide loads where every row and the scale start on a 4-element boundary.
    vec = d % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0 and scale.data_ptr() % 16 == 0
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            DTYPES[x.dtype], t, d, int(vec), float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    launches += 1
    return out
