"""Binding and launch of the RMSNorm kernels: the forward (``csrc/rmsnorm.cu``)
and its backward (``csrc/rmsnorm_bwd.cu``).

The forward replaces the Pallas TPU kernel
``repro.kernels.rmsnorm.rmsnorm_pallas``; the backward has no TPU
counterpart.  This module checks what the kernels take, allocates their
outputs, launches on PyTorch's current stream and counts the launches.
The plain version of the forward is
:func:`repro_torch.kernels.ref.rmsnorm_ref`; that of the backward is
autograd through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)
backward_launches = 0  # the same for the backward
MAX_BACKWARD_D = 56832  # the backward keeps a d-wide float32 partial in shared memory


@functools.cache
def _entry():
    fn = _build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_entries():
    lib = _build.load("rmsnorm_bwd")
    fn = lib.rmsnorm_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = lib.rmsnorm_bwd_blocks
    blocks.argtypes = [ctypes.c_int]
    blocks.restype = ctypes.c_int
    return fn, blocks


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


def rmsnorm_backward_cuda(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx in x's dtype, dscale float32) of
    :func:`rmsnorm_cuda` at (x, scale, eps) given the output's gradient
    ``dy``.  x, dy: (T, d); scale: (d,) float32; all on one CUDA device."""
    global backward_launches
    check_inputs(x, scale)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x {tuple(x.shape)}")
    t, d = x.shape
    if d > MAX_BACKWARD_D:
        raise ValueError(f"d = {d}: the backward takes d up to {MAX_BACKWARD_D}")
    if x.device.type != "cuda" or scale.device != x.device or dy.device != x.device:
        raise ValueError(f"x, scale and dy must lie on one CUDA device; got {x.device}, "
                         f"{scale.device}, {dy.device}")
    dy = dy.to(x.dtype).contiguous()
    fn, blocks = _backward_entries()
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    partial = torch.empty((blocks(t), d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            dscale.data_ptr(), DTYPES[x.dtype], t, d, float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: cudaError {err}")
    backward_launches += 1
    return dx, dscale
