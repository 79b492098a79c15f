"""Binding and launch of the MoE top-k gating kernels: the forward
(``csrc/moe_gating.cu``) and the backward of its gates
(``csrc/moe_gating_bwd.cu``).

The forward replaces the Pallas TPU kernel
``repro.kernels.moe_gating.moe_gating_pallas``; the backward has no TPU
counterpart.  This module checks what the kernels take, allocates their
outputs, launches on PyTorch's current stream and counts the launches.
The plain version of the forward is
:func:`repro_torch.kernels.ref.moe_gating_ref`; that of the backward is
autograd through its gates.
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
backward_launches = 0  # the same for the backward


@functools.cache
def _entry():
    fn = _build.load("moe_gating").moe_gating_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_entry():
    fn = _build.load("moe_gating_bwd").moe_gating_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    _build.refuse_autograd("moe_gating", logits)
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


def moe_gating_backward_cuda(
    logits: torch.Tensor, ids: torch.Tensor, dgates: torch.Tensor
) -> torch.Tensor:
    """The gradient of the logits (T, E), in their dtype, through the gates
    of :func:`moe_gating_cuda`: ``ids`` (T, k) int32 as it returned them,
    ``dgates`` (T, k) the gates' gradient.  The ids carry none."""
    global backward_launches
    check_inputs(logits, ids.shape[-1] if ids.dim() == 2 else 0)
    t, e = logits.shape
    k = ids.shape[1]
    if ids.shape != (t, k) or ids.dtype != torch.int32 or dgates.shape != (t, k):
        raise ValueError(f"ids {tuple(ids.shape)} {ids.dtype} / dgates {tuple(dgates.shape)} do not "
                         f"fit logits {tuple(logits.shape)}")
    if logits.device.type != "cuda" or ids.device != logits.device or dgates.device != logits.device:
        raise ValueError(f"logits, ids and dgates must lie on one CUDA device; got {logits.device}, "
                         f"{ids.device}, {dgates.device}")
    ids = ids.contiguous()
    dgates = dgates.float().contiguous()
    dlogits = torch.empty_like(logits)
    fn = _backward_entry()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            logits.data_ptr(), ids.data_ptr(), dgates.data_ptr(), dlogits.data_ptr(),
            DTYPES[logits.dtype], t, e, k, stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_gating backward kernel launch failed: cudaError {err}")
    backward_launches += 1
    return dlogits
