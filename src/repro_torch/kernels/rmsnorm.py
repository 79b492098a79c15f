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
from typing import NamedTuple

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)
backward_launches = 0  # the same for the backward
MAX_BACKWARD_D = 56832  # the rereading backward keeps a d-wide float32 partial in shared memory


class BackwardPlan(NamedTuple):
    """How the backward's first launch covers (T, d): teams of ``team``
    threads, ``teams`` a block, ``blocks`` blocks (and rows of the float32
    dscale partial), each thread ``vpt`` groups of ``vec`` columns held in
    registers; ``vpt == 0`` takes the rereading kernel (256 threads a block)."""

    vec: int
    vpt: int
    team: int
    teams: int
    blocks: int


def backward_plan(t: int, d: int, element_size: int, aligned: bool, sms: int) -> BackwardPlan:
    """The backward's plan for a (T, d) input whose elements take
    ``element_size`` bytes: 16-byte vectors where d is a multiple of one and
    ``aligned`` (x, dy and scale start on 16-byte boundaries), else single
    columns; the fewest vectors a thread (1, 2, 4 or 8, at most 32 columns)
    that keep a team within 256 threads, else the rereading kernel.  Teams
    fill a block of 512 threads (256 where a thread holds 32 columns: its
    registers), at most 8; two blocks a multiprocessor at most."""
    vec = 16 // element_size if aligned and d % (16 // element_size) == 0 else 1
    groups = -(-d // vec)
    for vpt in (1, 2, 4, 8):
        team = 32 * -(-groups // (32 * vpt))
        if team <= 256 and vpt * vec <= 32:
            teams = min(8, (512 if vpt * vec <= 16 else 256) // team)
            return BackwardPlan(vec, vpt, team, teams, min(-(-t // teams), 2 * sms))
    return BackwardPlan(vec, 0, 256, 1, min(t, 2 * sms))


@functools.cache
def _entry():
    fn = _build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_entry():
    fn = _build.load("rmsnorm_bwd").rmsnorm_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
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
    fn = _backward_entry()
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    aligned = all(p.data_ptr() % 16 == 0 for p in (x, dy, scale))
    plan = backward_plan(t, d, x.element_size(), aligned, _build.sm_count(x.device))
    partial = torch.empty((plan.blocks, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            dscale.data_ptr(), DTYPES[x.dtype], t, d, float(eps), *plan, stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: cudaError {err}")
    backward_launches += 1
    return dx, dscale
