"""Binding and launch of Mamba's selective scan (``csrc/selective_scan.cu``).

It replaces no TPU kernel: the JAX package computes the scan in ``jnp``.
This module holds the plan that cuts S into runs scanned side by side
(:func:`scan_plan`) and the launcher, which refuses what the kernel does
not take (:func:`check_inputs`), allocates y, the last state and the runs'
scratch, launches on PyTorch's current stream and counts the launches (one
a scan, whether it takes one kernel or two).  The plain version is
:func:`repro_torch.kernels.ref.selective_scan_ref`, one position at a time;
the model's own route off the card is the doubling scan of
:mod:`repro_torch.models.ssm`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)
N_STATES = (16,)  # the state sizes the kernel is built for
CHANNELS = 64  # channels a block (``csrc/selective_scan.cu``'s kChannels)
STEPS = 32  # positions a tile: a run is a multiple of it
MIN_RUN = 128  # the shortest run worth a second pass over its positions
BLOCKS_PER_SM = 4  # blocks of 64 threads an SM should hold to hide a position's latency


def scan_plan(b: int, s: int, e: int, sms: int) -> tuple[int, int]:
    """(run_len, chunks): S cut into ``chunks`` runs of ``run_len``
    positions (a multiple of ``STEPS``, the last run taking the rest), so
    that the (channel block, batch row, run) blocks number about
    ``BLOCKS_PER_SM`` an SM, each run at least ``MIN_RUN`` long; one run
    where the batch rows already fill the card."""
    blocks = -(-e // CHANNELS) * b
    want = max(1, min(-(-BLOCKS_PER_SM * sms // blocks), s // MIN_RUN))
    run_len = STEPS * -(-s // (want * STEPS))
    return run_len, -(-s // run_len)


@functools.cache
def _entry():
    fn = _build.load("selective_scan").selective_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(x, dt, bm, cm, z, a_log, d_skip) -> None:
    """Raise on input the kernel does not take (any device): a DTensor (no
    sharding rule), a shape that does not fit, a state other than
    ``N_STATES``, another dtype than float32, a strided or unaligned tensor."""
    if any(type(t) is not torch.Tensor for t in (x, dt, bm, cm, z, a_log, d_skip)):
        raise TypeError("the selective scan takes plain tensors; it has no DTensor sharding rule")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, E); got {tuple(x.shape)}")
    b, s, e = x.shape
    n = a_log.shape[-1] if a_log.dim() == 2 else -1
    want = {"dt": (dt, (b, s, e)), "z": (z, (b, s, e)), "bm": (bm, (b, s, n)), "cm": (cm, (b, s, n)),
            "a_log": (a_log, (e, n)), "d_skip": (d_skip, (e,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit x {tuple(x.shape)}: want {shape}")
    if n not in N_STATES or e % 4 or b * s * e == 0:
        raise ValueError(f"the kernel takes N in {N_STATES} and E a positive multiple of 4; got {n}, {e}")
    for t in (x, dt, bm, cm, z, a_log, d_skip):
        if t.dtype != torch.float32:
            raise TypeError(f"every input must be float32; got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("every input must be contiguous and start on a 16-byte boundary")


def selective_scan_cuda(x, dt, bm, cm, z, a_log, d_skip, *, last_state: bool = False):
    """x, dt, z: (B, S, E); bm, cm: (B, S, N); a_log: (E, N); d_skip: (E,);
    float32 on one CUDA device → (y (B, S, E), the state after the last
    position (B, E, N), or an empty (0,) tensor without ``last_state``)."""
    global launches
    check_inputs(x, dt, bm, cm, z, a_log, d_skip)
    _build.refuse_autograd("selective_scan", x, dt, bm, cm, z, a_log, d_skip)
    devices = {t.device for t in (x, dt, bm, cm, z, a_log, d_skip)}
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"all inputs must lie on one CUDA device; got {devices}")
    b, s, e = x.shape
    n = a_log.shape[1]
    run_len, chunks = scan_plan(b, s, e, _build.sm_count(x.device))
    y = torch.empty_like(x)
    h = torch.empty((b, e, n) if last_state else (0,), dtype=torch.float32, device=x.device)
    runs = chunks - 1
    run_h = torch.empty((b, runs, e, n), dtype=torch.float32, device=x.device) if runs else None
    run_dt = torch.empty((b, runs, e), dtype=torch.float32, device=x.device) if runs else None
    fn = _entry()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), z.data_ptr(),
                 a_log.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                 h.data_ptr() if last_state else None,
                 run_h.data_ptr() if runs else None, run_dt.data_ptr() if runs else None,
                 b, s, e, n, run_len, chunks, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: cudaError {err}")
    launches += 1
    return y, h

