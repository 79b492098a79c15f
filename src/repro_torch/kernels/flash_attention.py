"""Binding and launch of the flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its backward (``csrc/flash_attention_bwd.cu``).

The forward replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``; the backward has
no TPU counterpart (the JAX trainer differentiates einsums).  This module
checks what the kernels take, makes the forward's launch plan
(:func:`flash_plan`, a pure function of the shapes, the type and the card's
multiprocessor count), allocates the outputs, launches on PyTorch's
current stream and counts the launches.  The plain version of the forward
is :func:`repro_torch.kernels.ref.flash_attention_ref`; that of the
backward is autograd through it.
"""

from __future__ import annotations

import ctypes
import dataclasses
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

# The forward's routes (``csrc/flash_attention.cu``): "wgmma", the Hopper
# route (TMA ring, wgmma products, one block a GQA group's query tile), and
# "mma_sync", the Ampere instruction set (a block a query head's tile).
ROUTES = {"mma_sync": 0, "wgmma": 1}
MAX_SHARED = 232_448  # shared memory a block can use on the H100
SM_SHARED = 233_472  # an SM's shared memory (228 KB)
MAX_WARPGROUPS, MAX_STAGES = 2, 4  # the wgmma route's consumer warpgroups a block; ring depth
# The wgmma route's keys a tile (``Hop<T, HD>::kBlockK``): float32 stages
# five tile copies (K, its small part, V, Vᵀ big and small), bf16 two.
WGMMA_BLOCK_K = {True: {16: 32, 32: 32, 64: 32, 128: 16, 192: 16}, False: dict.fromkeys(HEAD_DIMS, 64)}
MMA_SYNC_BLOCK_K = 16  # the mma.sync route's keys a tile (``kBlockK`` at head size 192)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How one forward call is launched.  ``route``: "wgmma" or
    "mma_sync"; ``warps``: the wgmma route's consumer warpgroups a block (64
    query rows each), the mma_sync route's warps (16 rows each);
    ``heads`` x ``positions``: the query heads and positions whose rows a
    block holds (mma_sync: one head); ``block_k``: keys a tile; ``stages``:
    the ring's tiles in flight; ``shared_bytes``: dynamic shared memory a
    block (the kernel's layout; the launcher refuses any other)."""

    route: str
    group: int
    heads: int
    positions: int
    warps: int
    block_k: int
    stages: int
    shared_bytes: int

    @property
    def rows(self) -> int:
        """The query rows a block holds."""
        return self.heads * self.positions


def wgmma_shared_bytes(hd: int, f32: bool, warpgroups: int, stages: int) -> int:
    """``Hop<T, HD>::shared_bytes``: Q (and its small part in float32) for
    64 rows a warpgroup, the ring's stages, 128 bytes of mbarriers."""
    row = hd * (4 if f32 else 2)
    tile = WGMMA_BLOCK_K[f32][hd] * row
    return (2 if f32 else 1) * 64 * warpgroups * row + stages * (5 if f32 else 2) * tile + 128


def blocks_per_sm(shared_bytes: int) -> int:
    """Blocks an H100 SM holds by shared memory: 228 KB an SM, 1 KB of it
    reserved a block."""
    return SM_SHARED // (shared_bytes + 1024)


def mma_sync_shared_bytes(hd: int, warps: int) -> int:
    """``Tile<float, HD, 16>::shared_bytes``: Q's rows and a two-stage ring
    of 16-key K/V tiles, float32 rows padded for conflict-free fragment
    loads (hd + 8 for Q and K, hd + 4 for V)."""
    return (16 * warps * (hd + 8) + 2 * MMA_SYNC_BLOCK_K * (2 * hd + 12)) * 4


def mma_sync_plan(h: int, kv: int, s: int, hd: int) -> FlashPlan:
    """The mma.sync route's plan: 2 warps (32 query rows) for S <= 32, else 4
    (the route is built for float32 at head size 192)."""
    warps = 2 if s <= 32 else 4
    return FlashPlan("mma_sync", h // kv, 1, 16 * warps, warps, MMA_SYNC_BLOCK_K, 2,
                     mma_sync_shared_bytes(hd, warps))


def wgmma_plan(b: int, h: int, kv: int, s: int, hd: int, dtype: torch.dtype, sms: int,
               warpgroups: int | None = None, stages: int | None = None) -> FlashPlan | None:
    """The wgmma route's plan with ``warpgroups`` and ``stages`` given, or
    chosen: one warpgroup for bf16 up to head size 64 (its few registers
    leave several blocks an SM, which the card measures faster); else two
    where their shared memory leaves a ring of two stages, the rows fill
    more than one warpgroup and the blocks still cover the card's
    multiprocessors, else one; then 2 stages (the
    consumers hold one tile's P·V beside the next one's Q·Kᵀ), and more, up
    to 4, where they leave as many blocks an SM.  A block holds
    the whole GQA group (or the largest divisor of it that fits 64 rows a
    warpgroup) at ``64·warpgroups // heads`` positions.  None where no plan
    with these fits."""
    f32 = dtype == torch.float32
    g = h // kv
    bk = WGMMA_BLOCK_K[f32][hd]

    def make(wgs: int, st: int | None) -> FlashPlan | None:
        heads = next(d for d in range(min(g, 64 * wgs), 0, -1) if g % d == 0)
        positions = min(64 * wgs // heads, s)
        size = lambda n: wgmma_shared_bytes(hd, f32, wgs, n)  # noqa: E731
        fit = (MAX_SHARED - size(0)) // (size(1) - size(0))
        if st is None:
            st = 2
            while st < min(fit, MAX_STAGES) and blocks_per_sm(size(st + 1)) == blocks_per_sm(size(2)):
                st += 1
        if st < 2 or st > min(fit, MAX_STAGES):
            return None
        return FlashPlan("wgmma", g, heads, positions, wgs, bk, st, size(st))

    if warpgroups is not None:
        return make(warpgroups, stages)
    if not f32 and hd <= 64:
        return make(1, stages)  # few registers: several blocks an SM beat two warpgroups a block
    two = make(2, stages)
    if two is not None and two.rows > 64:
        blocks = b * kv * (g // two.heads) * -(-s // two.positions)
        if blocks >= sms:
            return two
    return make(1, stages)


@functools.lru_cache(maxsize=256)
def flash_plan(b: int, h: int, kv: int, s: int, hd: int, dtype: torch.dtype, window: int,
               sms: int) -> FlashPlan:
    """The launch plan of ``flash_attention_cuda`` for q (b, h, s, hd) over
    (b, kv, s, hd) keys of ``dtype`` on a card of ``sms`` multiprocessors:
    the wgmma route (:func:`wgmma_plan`), except at the shapes where the card
    measures the mma.sync route faster (:func:`mma_sync_faster`).
    ``window`` (0: none), the sliding window, is taken so that the plan sees
    every shape of a call; no rule reads it yet."""
    if mma_sync_faster(hd, dtype):
        return mma_sync_plan(h, kv, s, hd)
    return wgmma_plan(b, h, kv, s, hd, dtype, sms)


def mma_sync_faster(hd: int, dtype: torch.dtype) -> bool:
    """Where the mma.sync route beats the wgmma route on the H100
    (``scripts/flash_variants.py --probe plans``): float32 at head size 192,
    where Q's two parts and a two-stage ring leave room for one consumer
    warpgroup an SM (Nemotron-4-340B's group of 12).  The launcher builds
    neither route at the other's shapes."""
    return dtype == torch.float32 and hd == 192


_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_ptr = ctypes.c_void_p


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([_c_ptr] * 6 + [_c_int] * 6 + [_c_ll] * 9 + [_c_int, _c_int, _c_int, ctypes.c_float]
                   + [_c_int] * 6 + [_c_ll, _c_ptr])
    fn.restype = _c_int
    return fn


@functools.cache
def _backward_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [_c_ptr] * 12 + [_c_int] * 8 + [ctypes.c_float, _c_int, _c_ptr]
    fn.restype = _c_int
    return fn


def check_inputs(q, k, v, lengths, softcap: float = 0.0, prefix: int = 0) -> None:
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
    # The kernel copies rows with TMA or 16-byte cp.async: every row of q,
    # k, v must start on a 16-byte boundary.
    for t in (q, k, v):
        steps = [st * t.element_size() for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st % 16 for st in steps):
            raise ValueError("every row of q, k, v must start on a 16-byte boundary (TMA, cp.async)")
    if lengths is not None:
        if lengths.shape != (b,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
            raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    if not softcap >= 0:
        raise ValueError(f"softcap must be >= 0 (0: none), got {softcap}")
    if prefix < 0:
        raise ValueError(f"prefix must be >= 0 (0: none), got {prefix}")


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
    prefix: int = 0,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) on one CUDA device → (B, H, S, hd)
    in q's dtype.  Keys at or past ``lengths[b]`` are masked (``None``: all S);
    with a ``window``, the keys below ``prefix`` stay visible to every query;
    ``softcap > 0`` caps the scaled scores (tanh(s / cap) · cap) before the masks.
    With ``return_lse`` also each row's log-sum-exp of its scores, (B, H, S)
    float32, -inf for a row with no valid key: what the backward reads."""
    global launches
    check_inputs(q, k, v, lengths, softcap, prefix)
    _build.refuse_autograd("flash_attention", q, k, v)
    _check_device(q, k, v, lengths)
    b, h, s, hd = q.shape
    plan = flash_plan(b, h, k.shape[1], s, hd, q.dtype, int(window), _build.sm_count(q.device))
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
            int(causal), int(window), int(prefix), float(softcap),
            ROUTES[plan.route], plan.warps, plan.heads, plan.positions, plan.block_k, plan.stages,
            plan.shared_bytes, stream,
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
