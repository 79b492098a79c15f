"""Binding and launch of the float32 GEMM (``csrc/gemm.cu``): the model's
weight products ``x @ w`` as split TF32 on the tensor cores.

It replaces no TPU kernel: the JAX package leaves these products to XLA.
This module holds the plain version (:func:`gemm_ref`, ``x @ w``), the rule
that routes a product to the kernel (:func:`takes`), the launch plan
(:func:`gemm_plan`, a pure function of the shapes and the card's
multiprocessor count), and the launcher, which checks what the kernel
takes, allocates the output and the split-K workspace, launches on
PyTorch's current stream and counts the launches (one a product, also
where a split product launches its reduction too).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

# The kernel's layout (``csrc/gemm.cu``): mirrored here, change both.
TOKENS = (8, 16, 32, 64, 128)  # token rows a block (wgmma's N widths built)
WARPGROUPS = 2  # consumer warpgroups a block, 64 output features each
FEATURES = 64 * WARPGROUPS  # output features a block
BLOCK_K = 32  # K a tile: one 128-byte row of float32
MAX_STAGES = 8
MAX_SHARED = 232_448  # shared memory a block can use on the H100
BARRIER_BYTES = 256

# The plan's cost model (seconds): the tensor cores' float32 work through
# three TF32 passes (495 / 3 TFLOP/s) shared by the multiprocessors, and
# device memory's 3.35 TB/s (the H100's published rates); what a block
# costs whatever its work (its prologue, first loads and epilogue), what a
# K tile costs besides its products (its fragments' loads and splits, the
# ring's barriers), what a split call's reduction costs (its launch, and a
# split's partial read in turn), and the share of the multiprocessors
# whose blocks draw the whole bandwidth: fitted to the card's plan
# searches (``scripts/gemm_plans.py``; PERF.md §6), where the model's plan
# came within 3% of the fastest at every GLM-4-9B product and M of 1 to
# 2048.  Those searches also found rings deeper than 4 stages no faster.
SM_FLOPS = 495e12 / 3 / 132
MEMORY_BYTES_PER_S = 3.35e12
BLOCK_S = 2e-6
TILE_S = 0.2e-6
REDUCE_S = 2e-6
REDUCE_SPLIT_S = 0.1e-6
STREAMING_SHARE = 0.75
RING_STAGES = 4
MAX_PARTIAL_BYTES = 256 << 20  # a split call's workspace at most


def stage_bytes(tokens: int) -> int:
    """A ring stage: W's 32 x 128 tile, X's tokens x 32 tile and its small part."""
    return FEATURES * BLOCK_K * 4 + 2 * tokens * BLOCK_K * 4


def shared_bytes(tokens: int, stages: int) -> int:
    """``Gemm<T>::shared_bytes``: the ring's stages and the mbarriers."""
    return stages * stage_bytes(tokens) + BARRIER_BYTES


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How one product (m, n, k) is launched: ``tokens`` rows of X a block,
    ``warpgroups`` consumer warpgroups (64 output features each), K tiles of
    ``block_k``, a ring of ``stages``, ``splits`` blocks a tile along K of
    ``tiles_per_split`` K tiles each (the last takes the rest), and the
    dynamic shared bytes a block (the kernel's layout; the launcher refuses
    any other)."""

    tokens: int
    warpgroups: int
    block_k: int
    stages: int
    splits: int
    tiles_per_split: int
    shared_bytes: int

    def tiles(self, m: int, n: int) -> int:
        """Output tiles (token tiles x feature tiles): the blocks of one split."""
        return -(-m // self.tokens) * -(-n // (64 * self.warpgroups))


def token_width(m: int) -> int:
    """The token rows a block: the narrowest width that holds all ``m``
    rows, or, above 128, the width of 64 or 128 that pads the fewest rows
    (the wider of a tie)."""
    if m <= TOKENS[-1]:
        return next(t for t in TOKENS if t >= m)
    return min((64, 128), key=lambda t: (-(-m // t) * t, -t))


def max_stages(tokens: int) -> int:
    """The deepest ring that fits a block's shared memory."""
    return min(MAX_STAGES, (MAX_SHARED - BARRIER_BYTES) // stage_bytes(tokens))


def split_plan(k: int, splits: int) -> tuple[int, int]:
    """(splits, K tiles a split) for ``splits`` asked along K: equal runs,
    the last taking the rest, and no split left without a tile."""
    k_tiles = -(-k // BLOCK_K)
    per = -(-k_tiles // max(1, min(splits, k_tiles)))
    return -(-k_tiles // per), per


def plan_seconds(m: int, n: int, k: int, tokens: int, splits: int, sms: int) -> float:
    """The cost model's time of a launch: the waves of blocks, each paying
    ``BLOCK_S`` and, a K tile, ``TILE_S`` and its products at ``SM_FLOPS``,
    or the weight's bytes at the bandwidth that the blocks in flight draw,
    whichever is longer; and a split call's reduction (a launch, a split's
    partial read in turn, and the partials written and read back)."""
    splits, per = split_plan(k, splits)
    tiles = -(-m // tokens) * -(-n // FEATURES)
    blocks = tiles * splits
    waves = -(-blocks // sms)
    compute = waves * (BLOCK_S + per * (TILE_S + 2 * tokens * FEATURES * BLOCK_K / SM_FLOPS))
    streaming = min(1.0, min(blocks, sms) / (STREAMING_SHARE * sms))
    memory = 4 * k * n / (MEMORY_BYTES_PER_S * streaming)
    reduce = 0.0
    if splits > 1:
        reduce = REDUCE_S + splits * REDUCE_SPLIT_S + 2 * partial_floats(m, n, splits) * 4 / MEMORY_BYTES_PER_S
    return max(compute, memory) + reduce


def partial_floats(m: int, n: int, splits: int) -> int:
    """The split-K workspace's floats: an (m, n) partial a split."""
    return splits * m * n if splits > 1 else 0


@functools.lru_cache(maxsize=1024)
def gemm_plan(m: int, n: int, k: int, sms: int) -> GemmPlan:
    """The launch plan of ``gemm_cuda`` for x (m, k) @ w (k, n) on a card of
    ``sms`` multiprocessors: up to 128 rows the narrowest token width that
    holds them, above it 64 or 128; a ring of ``RING_STAGES``; and of
    those widths and 1 to 64 splits along K, the plan that the cost model
    (:func:`plan_seconds`) times fastest (the fewest splits, then the wider
    width, of a tie), a split call's workspace within
    ``MAX_PARTIAL_BYTES``."""
    best = None
    for tokens in (token_width(m),) if m <= TOKENS[-1] else (64, 128):
        for s in range(1, 65):
            splits, _ = split_plan(k, s)
            if splits != s or partial_floats(m, n, s) * 4 > MAX_PARTIAL_BYTES:
                continue
            key = (plan_seconds(m, n, k, tokens, s, sms), s, -tokens)
            best = key if best is None else min(best, key)
    _, s, tokens = best
    tokens = -tokens
    splits, per = split_plan(k, s)
    stages = min(RING_STAGES, max_stages(tokens))
    return GemmPlan(tokens, WARPGROUPS, BLOCK_K, stages, splits, per, shared_bytes(tokens, stages))


def gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: x (M, K) @ w (K, N)."""
    return x @ w


def tma_rows(t: torch.Tensor) -> bool:
    """Whether a 2-D tensor's rows are contiguous, 16 bytes apart in
    multiples and start on a 16-byte boundary (what TMA addresses)."""
    return (t.stride(1) == 1 and (t.stride(0) * t.element_size()) % 16 == 0
            and t.data_ptr() % 16 == 0)


def weight_2d(w: torch.Tensor) -> torch.Tensor | None:
    """w (K, *N) as a (K, N) view with N contiguous, or None where no view
    has one (a transposed table)."""
    try:
        return w.view(w.shape[0], -1)
    except RuntimeError:
        return None


def _on_card(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cuda" for t in tensors)


def takes(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the kernel computes x (..., K) @ w (K, *N): CUDA float32
    tensors whose product needs no gradient (training keeps its own
    products), K and N multiples of 4, rows present, and w's (K, N) view
    N-contiguous with 16-byte rows that TMA can address.  Anything else
    (the CPU, bf16, a gradient, a vocabulary of 50257) takes the plain
    product."""
    if not _on_card(x, w):
        return False
    if x.dtype != torch.float32 or w.dtype != torch.float32 or _build.needs_grad(x, w):
        return False
    k = x.shape[-1]
    if w.dim() < 2 or w.shape[0] != k or k == 0 or k % 4 or x.numel() == 0:
        return False
    w2 = weight_2d(w)
    return w2 is not None and w2.shape[1] > 0 and w2.shape[1] % 4 == 0 and tma_rows(w2)


_c_ptr = ctypes.c_void_p
_c_ll = ctypes.c_longlong
_c_int = ctypes.c_int


@functools.cache
def _entry():
    fn = _build.load("gemm").gemm_launch
    fn.argtypes = ([_c_ptr, _c_ll, _c_ptr, _c_ll, _c_ptr, _c_ll, _c_ptr] + [_c_int] * 9
                   + [_c_ll, _c_ptr])
    fn.restype = _c_int
    return fn


def check_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on input the kernel does not take (any device)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x must be (M, K) and w (K, N); got {tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or k == 0 or n == 0 or k % 4 or n % 4:
        raise ValueError(f"M, K and N must be positive, K and N multiples of 4; got {m}, {k}, {n}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"x and w must be float32; got {x.dtype}, {w.dtype}")
    if not tma_rows(x) or not tma_rows(w):
        raise ValueError("x's and w's rows must be contiguous, start on 16-byte boundaries "
                         "and lie a multiple of 16 bytes apart (TMA)")


def gemm_cuda(x: torch.Tensor, w: torch.Tensor, plan: GemmPlan | None = None) -> torch.Tensor:
    """x (M, K) @ w (K, N), float32 on one CUDA device, → (M, N) float32,
    contiguous; ``plan`` (default :func:`gemm_plan`'s) is checked by the
    launcher."""
    global launches
    check_inputs(x, w)
    _build.refuse_autograd("gemm", x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x and w must lie on one CUDA device; got {x.device}, {w.device}")
    m, k = x.shape
    n = w.shape[1]
    if plan is None:
        plan = gemm_plan(m, n, k, _build.sm_count(x.device))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _entry()
    partial = (torch.empty(partial_floats(m, n, plan.splits), dtype=torch.float32, device=x.device)
               if plan.splits > 1 else None)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0), y.data_ptr(), n,
            partial.data_ptr() if partial is not None else None, m, n, k, plan.tokens, plan.warpgroups, plan.block_k, plan.stages, plan.splits,
            plan.tiles_per_split, plan.shared_bytes, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gemm kernel launch failed: cudaError {err}")
    launches += 1
    return y


def flops(m: int, n: int, k: int) -> int:
    """A product's FLOPs: a multiply and an add per (row, column, k)."""
    return 2 * m * n * k


def weight_products(cfg) -> int:
    """The float32 weight products of one forward of a dense attention
    model (``linear`` and ``merge_heads`` calls): q, k, v and o, the MLP's
    two or three, a layer, and the head (none where it is tied)."""
    mlp = {"swiglu": 3, "none": 0}.get(cfg.mlp, 2)
    return cfg.n_layers * (4 + mlp) + (0 if cfg.tie_embeddings else 1)
