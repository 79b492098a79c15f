"""Binding and launch of the decode-attention kernel (``csrc/decode_attention.cu``).

The CUDA kernel replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``.  This module
checks what the kernel takes, makes its launch plan (:func:`decode_plan`, a
pure function of the shapes, the types and the card's multiprocessor
count), allocates the output, launches on PyTorch's current stream and
counts the launches.  The plain version of the same function is
:func:`repro_torch.kernels.ref.decode_attention_ref`.
"""

from __future__ import annotations

import ctypes
import dataclasses
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

# The tensor-core route holds a group's query heads in 16-row M tiles, at
# most four a block (their split queries and the block's state must fit
# its shared memory at head size 192).
MAX_GROUP = 64

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

# The kernel's constants (``csrc/decode_attention.cu``), which the plan
# sizes its blocks by.  The plan's shared bytes follow the kernel's layout
# (``*_shared_bytes`` there): here so that the plan is made, and tested,
# where no kernel is built; the launcher refuses bytes that differ from
# its own count.
ROUTES = {"simt": 0, "tensor_cores": 1, "wide": 2}
MAX_CLUSTER = 8  # blocks of a thread-block cluster (the portable limit)
MAX_SHARED = 232_448  # shared memory a block can use on the H100
# Shared memory of a block that leaves room for a second one on its SM (the
# SM's 228 KB less 1 KB reserved a block, halved).
TWO_A_SM = 115_712
# Clusters of 1 .. 8 blocks that the H100 SXM holds at once at one block an
# SM (cudaOccupancyMaxActiveClusters): a cluster's blocks share a GPC, so
# the GPCs' SM counts, not the 132 SMs, bound it.  At two blocks an SM the
# card holds twice as many (30 clusters of 8).
CLUSTERS_AT_ONE_A_SM = (132, 66, 39, 30, 22, 17, 15, 15)
SIMT_TILE, SIMT_MAX_WARPS, SIMT_STAGE_BYTES = 32, 8, 160 * 1024
TC_KEYS, TC_MAX_WARPS = 16, 8  # keys of a warp's share of a stage; warps a block
WIDE_KEYS, WIDE_WARPS, WIDE_STAGES = 2, 4, 2  # a warp's keys a stage; warps a block; ring depth


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How one call is launched.  ``route``: "simt" (groups of 1 to 4),
    "tensor_cores" (larger groups) or "wide" (head size 512); ``heads``: the
    query-head rows a block holds (the SIMT route's group rounded up to 1, 2
    or 4; 16 a tensor-core M tile; 1); ``warps`` a block; ``stages``: the
    SIMT route's 32-key tile slots, the others' cp.async ring depth;
    ``stage_keys``: keys a block stages at once; ``cluster``: blocks a
    (batch row, KV head), splitting its cache along S; the shared bytes a
    block, dynamic (handed to the launch) and static (the SIMT kernel's)."""

    route: str
    group: int
    heads: int
    warps: int
    stages: int
    stage_keys: int
    cluster: int
    dynamic_bytes: int
    static_bytes: int = 0

    @property
    def m_tiles(self) -> int:
        return self.heads // 16 if self.route == "tensor_cores" else 0

    @property
    def shared_bytes(self) -> int:
        return self.dynamic_bytes + self.static_bytes

    @property
    def cache_reads(self) -> int:
        """How many times the kernel reads each cache element: once per
        block of ``heads`` query heads of the group."""
        return -(-self.group // self.heads)


def _merge_floats(rows: int, hd: int, parts: int) -> int:
    """The merge's shared floats (``merge_floats`` in the kernel): the
    block's state and the warps' (m, l), each region a multiple of 16 bytes."""
    pad4 = lambda x: (x + 3) & ~3  # noqa: E731
    return rows * hd + 2 * pad4(rows) + 2 * pad4(parts * rows)


def _tc_parts(h: int, kv: int, hd: int, q_es: int, es: int, key_warps: int) -> tuple[int, int, int]:
    """The tensor-core kernel's shared bytes (``tc_shared_bytes`` in the
    kernel) in three parts: fixed (the merge's state and the split
    queries), one ring stage, and the warps' states, which reuse the ring.
    Float32 caches: the queries' two TF32 parts in float32, K rows of hd + 8
    and V rows of hd + 4 floats; bf16 caches: the queries' bf16 parts (3 of
    float32 queries, 1 of bf16 ones), K and V rows of hd + 8."""
    rows = 16 * -(-(h // kv) // 16)
    if es == 4:
        q_bytes, row_bytes = 2 * rows * (hd + 8) * 4, (2 * hd + 12) * 4
    else:
        q_bytes, row_bytes = (3 if q_es == 4 else 1) * rows * (hd + 8) * 2, 2 * (hd + 8) * 2
    return (4 * _merge_floats(rows, hd, key_warps) + q_bytes, TC_KEYS * key_warps * row_bytes,
            4 * key_warps * rows * hd)


def tc_shared_bytes(h: int, kv: int, hd: int, q_dtype: torch.dtype, cache_dtype: torch.dtype,
                    key_warps: int, stages: int) -> int:
    """Dynamic shared bytes of a tensor-core block of ``key_warps`` key
    warps and a ring of ``stages`` stages."""
    fixed, stage_bytes, states = _tc_parts(h, kv, hd, q_dtype.itemsize, cache_dtype.itemsize, key_warps)
    return fixed + max(stages * stage_bytes, states)


def _cluster(b: int, kv: int, s: int, stage_keys: int, sms: int) -> int:
    """Blocks a (batch row, KV head): as many as it takes for the B·KV
    clusters to cover the multiprocessors four times, at most 8 and at most
    one a stage of the cache."""
    want = -(-4 * sms // (b * kv))
    return max(1, min(MAX_CLUSTER, want, -(-s // stage_keys)))


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, h: int, kv: int, s: int, hd: int, q_dtype: torch.dtype,
                cache_dtype: torch.dtype, sms: int) -> DecodePlan:
    """The launch plan of ``decode_attention_cuda`` for q (b, h, hd) over
    (b, kv, s, hd) caches of ``cache_dtype`` on a card of ``sms``
    multiprocessors.  The route follows the shapes: head size 512 the wide
    route, a group of up to 4 the SIMT route, a larger one the tensor cores,
    which hold the whole group in one block so that its cache is read once."""
    g = h // kv
    q_es, es = q_dtype.itemsize, cache_dtype.itemsize
    if hd == WIDE_HEAD_DIM:
        stage_keys = WIDE_KEYS * WIDE_WARPS
        cluster = _cluster(b, kv, s, stage_keys, sms)
        stages = min(WIDE_STAGES, -(-(-(-s // cluster)) // stage_keys))  # the ring, up to each warp's steps
        ring = WIDE_WARPS * stages * 2 * WIDE_KEYS * hd
        dynamic = 4 * (_merge_floats(1, hd, WIDE_WARPS) + max(ring, WIDE_WARPS * hd))
        return DecodePlan("wide", g, 1, WIDE_WARPS, stages, stage_keys, cluster, dynamic)
    if g <= 4:
        heads = 1 if g == 1 else 2 if g == 2 else 4
        slot_bytes = 2 * SIMT_TILE * (hd + 16 // es) * es
        tiles = -(-s // SIMT_TILE)
        max_slots = 1 if heads == 4 else SIMT_MAX_WARPS // heads
        slots = min(max_slots, tiles, SIMT_STAGE_BYTES // slot_bytes)
        cluster = _cluster(b, kv, s, slots * SIMT_TILE, sms)
        dynamic = max(slots * slot_bytes, slots * heads * hd * 4)
        static = 4 * (2 * heads * hd + 2 * heads + 2 * SIMT_MAX_WARPS * heads)
        return DecodePlan("simt", g, heads, heads * slots, slots, slots * SIMT_TILE, cluster,
                          dynamic, static)
    # The tensor cores: blocks a (row, KV head) of 128 keys or more each;
    # more (of 64 keys or more) where the B·KV pairs would not cover the
    # SMs once; at most 8, and at most 3 blocks an SM in all.  Then as many
    # key warps a block as its share of the keys takes, at most 4, within
    # the warps a block has and the shared memory that a ring of 2 stages
    # takes (1 where the block's keys fit one stage): two blocks' worth an
    # SM where the card cannot hold every cluster at one block an SM, else
    # one.  The ring prefetches every step of a block, up to 4 stages.
    m_tiles = -(-g // 16)
    rows = 16 * m_tiles
    pairs = b * kv
    cluster = min(MAX_CLUSTER, -(-s // (8 * TC_KEYS)))
    cluster = max(cluster, min(MAX_CLUSTER, -(-s // (4 * TC_KEYS)), sms // pairs))
    cluster = max(1, min(cluster, 3 * sms // pairs))
    per = -(-s // cluster)

    def sizes(key_warps: int) -> tuple[int, int, int, int]:
        """``_tc_parts``, and the bytes with a ring of 2 stages (1 where one
        holds the block's keys)."""
        fixed, stage_bytes, states = _tc_parts(h, kv, hd, q_es, es, key_warps)
        ring = min(2, -(-per // (TC_KEYS * key_warps))) * stage_bytes
        return fixed, stage_bytes, states, fixed + max(ring, states)

    budget = MAX_SHARED
    if pairs > CLUSTERS_AT_ONE_A_SM[cluster - 1] * sms // 132 and sizes(1)[3] <= TWO_A_SM:
        budget = TWO_A_SM
    for key_warps in (4, 2, 1):
        if key_warps > 1 and (key_warps * m_tiles > TC_MAX_WARPS or TC_KEYS * key_warps // 2 >= per):
            continue
        fixed, stage_bytes, states, need = sizes(key_warps)
        if need <= budget:
            break
    stage_keys = TC_KEYS * key_warps
    steps = -(-per // stage_keys)
    stages = max(1, min(4, steps + 1 if steps > 1 else 1, (budget - fixed) // stage_bytes))
    dynamic = fixed + max(stages * stage_bytes, states)
    return DecodePlan("tensor_cores", g, rows, key_warps * m_tiles, stages, stage_keys, cluster,
                      dynamic)


@functools.cache
def _entry():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p])
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
    if h // kv > MAX_GROUP:
        raise ValueError(f"a group of {h // kv} query heads a KV head; the kernel takes at most {MAX_GROUP}")
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
    plan = decode_plan(b, h, kv, s, hd, q.dtype, k_cache.dtype, _build.sm_count(q.device))
    fn = _entry()
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_len.data_ptr(),
            out.data_ptr(), DTYPES[q.dtype], DTYPES[k_cache.dtype], b, h, kv, s, hd,
            float(softcap), ROUTES[plan.route], plan.warps, plan.stages, plan.cluster,
            plan.dynamic_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
