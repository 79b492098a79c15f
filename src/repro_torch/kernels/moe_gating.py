"""Binding and launch of the MoE top-k gating kernel (``csrc/moe_gating.cu``).

The CUDA kernel replaces the Pallas TPU kernel
``repro.kernels.moe_gating.moe_gating_pallas``.  This module checks what the
kernel takes, allocates the outputs, launches on PyTorch's current stream
and counts the launches.  The plain version of the same function is
:func:`repro_torch.kernels.ref.moe_gating_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 256  # eight logits per lane of the row's warp
MAX_TOP_K = 32  # one pass's gate per lane

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)


@functools.cache
def _entry():
    fn = _build.load("moe_gating").moe_gating_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(logits, top_k: int) -> None:
    """Raise on input the kernel does not take (any device)."""
    if logits.dim() != 2 or logits.shape[0] == 0:
        raise ValueError(f"logits must be a non-empty (T, E) tensor; got {tuple(logits.shape)}")
    e = logits.shape[1]
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"{e} experts; the kernel takes 1 to {MAX_EXPERTS}")
    if not 1 <= top_k <= min(e, MAX_TOP_K):
        raise ValueError(f"top_k {top_k} must lie in 1..{min(e, MAX_TOP_K)} for {e} experts")
    if logits.dtype not in DTYPES:
        raise TypeError(f"logits must be one of {list(DTYPES)}; got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")


def moe_gating_cuda(logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: (T, E) on a CUDA device → (gates (T, k) float32, ids (T, k)
    int32), the gates renormalised over the k chosen experts."""
    global launches
    check_inputs(logits, top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"logits must lie on a CUDA device; got {logits.device}")
    t, e = logits.shape
    gates = torch.empty((t, top_k), dtype=torch.float32, device=logits.device)
    ids = torch.empty((t, top_k), dtype=torch.int32, device=logits.device)
    fn = _entry()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            logits.data_ptr(), gates.data_ptr(), ids.data_ptr(),
            DTYPES[logits.dtype], t, e, top_k, stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_gating kernel launch failed: cudaError {err}")
    launches += 1
    return gates, ids
