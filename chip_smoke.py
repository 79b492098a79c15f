#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of Orloj (serving and training) on one NVIDIA GPU.

    python3 chip_smoke.py        (from the root of a checkout; needs one card)

Phases, each reported on its own lines; any failure exits non-zero:

1. card: the GPU's name and power limit (``nvidia-smi``), the torch, CUDA
   and nvcc versions;
2. build: the nine kernels (flash and decode attention, RMSNorm, MoE
   gating, the backwards of flash attention, RMSNorm and the gates, the
   float32 GEMM and Mamba's selective scan)
   built from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, one
   nvcc a source, all started together, with each kernel's registers,
   spills and static shared memory from ``-Xptxas -v``;
3. kernels vs plain: each CUDA kernel against its plain PyTorch version on
   the card, at both models' shapes and at the edges of their tilings (the
   32-key bucket, S = 1, ragged S, groups of 1 to 8 query heads, empty and
   full caches, caches shorter than one split) (attention in float32 to
   1e-4: another order of summation, and the flash kernel's split-TF32
   products; RMSNorm and the gates in float32 to 1e-5: one row sum in
   another order; bfloat16 to 2e-2: one bf16 rounding, or one bf16 step
   of a bf16 output of magnitude 4 or more; the gating's expert
   ids exactly, also for ragged T, E of 3, 130 and 256, k == E, bf16,
   -inf logits and rows off 16 bytes); and the instantiations the models'
   decode path adds: decode groups of 16 and 48 query heads, float32
   queries over a bfloat16 cache (to 2e-2 against the plain version given
   the same bf16 cache), flash at GQA 16:1, and both kernels with a softcap,
   also at the shapes decode ≡ forward and the timed steps give them
   (flash at S 8 and hd 128, decode over 8 slots and at B 1 over 256); and
   both kernels at head_dim 16 (the engine-smoke toy: B <= 4, 4 heads, S 8
   to 32) and 192 (Nemotron-4-340B: flash (8,96->8,256,192), decode at a
   group of 12), in float32 and bf16, decode also over a bf16 cache; and
   the SSM and frontend models' shapes: flash at Hymba's groups of 5 with
   its window of 1024 (S 256, 1100 and 2048), InternVL2's group of 7 (S 256
   and 320) and MusicGen's bf16 heads, decode over Hymba's 1024-slot ring
   (float32 and bf16 caches), at InternVL2's group of 7 and in bf16/bf16 at
   MusicGen's group of 1, rmsnorm at Hymba's (2048, 1600); decode at head
   size 512 (xLSTM-1.3B's token path: a group of 1 in float32); decode at
   Granite-34B's g 48 over 4,096 slots (float32, and a bf16 cache with
   ragged valid_len), GLM-4-9B's g 16 at S 7 and over its bf16 cache at
   4,096 and 32,768 slots, DBRX's g 6; the flash forward's wgmma route
   at every head size in both types, at one and two consumer warpgroups,
   at groups of 4 to 48 with lengths, windows and S = 1 (DBRX's g 6 and
   Arctic's g 7 at head size 128 in float32), and its mma_sync route
   (float32 at head size 192), each line with the plan (``flash_attention.flash_plan``); flash
   with Hymba-1.5B's 128 meta tokens seen through its window of 1024 (the
   ``prefix``: its largest served batch (4,25->5,2176,64), ragged rows)
   and other prefixes in bf16 and at head size 192; the selective scan
   (y and the last state, to F32_TOL) at Hymba-1.5B's served (4, 2176)
   and (1, 2176) at inner width 3200, (8, 384), the narrow preset's (8,
   256) at 1600 and ragged shapes; then
   the flash forward on each route (GLM-4's training shape with its LSE,
   orloj_gpt's, MusicGen's bf16, Nemotron's, the smallest bucket) called
   twice, and captured in a CUDA graph replayed over rewritten inputs
   against an eager call on them, and the decode kernel on each
   route (tensor cores over bf16 and float32 caches, head size 512, SIMT)
   called twice and replayed in a CUDA graph, all bit-identical;
3b. backward vs plain: each backward kernel, through the ``ops``
   operators' autograd formulas, against autograd through its plain version on the same
   inputs and output gradients (relative to the largest gradient: flash in
   float32 to 1e-4, RMSNorm's dx and the gates to 1e-5, RMSNorm's dscale to
   1e-4, bf16 to 2e-2): flash at the training shapes (orloj_gpt's, GLM-4's
   GQA 16:1 at S 1024, Arctic's, Hymba's windows) and at head sizes 16, 32,
   128 and 192 with lengths, an empty row (zero gradients), softcap, full
   attention, S 1 and bf16, and the GQA splits of the dK/dV launch (groups
   of 16 at S 1000 with an empty row and in bf16 at S 512, of 4 at head size
   192 with a window); RMSNorm at GLM-4's, Arctic's and Hymba's widths,
   ragged d in float32 and bf16 and the widest it takes (56832, the
   rereading kernel); the gates at Arctic's, E 3 to 256, ties, -inf
   logits, bf16; then each redesigned backward (flash at GLM-4's shape,
   RMSNorm at (2048, 4096)) called twice, its gradients bit-identical;
3c. gemm: the float32 GEMM at GLM-4-9B's products and M 32, 128 and 256
   against the float64 product beside cuBLAS float32 and one TF32 pass
   (within 4x cuBLAS's error, 100x under one pass's), its graph-replay
   time and own duration beside its bound (weight bytes at 3.35 TB/s or
   the work at 165 TFLOP/s), ``x @ w`` and ``torch.matmul``; the forward's
   products summed at each M; two calls and a graph replayed over
   rewritten inputs bit for bit; its ``sass:`` census
   (``scripts/sass_census.py gemm``); the kernel line's ``gemm`` entry;
4. orloj_gpt: full width (12 layers, d 768, 12 heads, vocab 32000, weights
   from a seeded ``torch.Generator``) profiled for Eq. 3 and serving 100
   requests under the Orloj scheduler, each served shape (and the decode
   step) one CUDA graph, captured at its first use and replayed; at (1, 32)
   and (8, 256) the replayed logits held bit for bit against an eager
   forward, with the eager and the replayed ms and each one's profile
   (``graphs`` lines); the logits of a small batch held
   against the same weights on the CPU; 32 token requests through
   continuous batching on the decode kernel; ``torch.profiler`` over one
   full prefill batch and one decode step (replays);
5. arctic: Snowflake Arctic at full width (d 7168, 56 query heads on 8 KV
   heads, 128 experts top-2 beside a dense SwiGLU) cut to 1 layer, in
   float32 (56 GB of weights), through the same phases (graphs included); its card-vs-CPU
   check runs a second 1-layer full-width model with 8 experts and a
   512-word vocabulary, whose weights fit the host, and also holds the
   routing ids of both runs equal;
6. glm4: GLM-4-9B at full width and full depth (40 layers, d 4096, 32
   query heads on 2 KV heads of 128, vocab 151552; 37.6 GB of float32
   weights): decode ≡ forward, the decode step's time at B 1 and 8 (cache
   256) and at B 8 over its default bf16 cache at 32,768 slots beside the
   weight-read bound and the step's byte bound, its launches per step, a profile of
   one step, peak memory; then its widths cut to 1 layer and a 512-word
   vocabulary, decode steps on the card against the same weights on the
   CPU with a float32 and a bfloat16 cache;
7. nemotron: Nemotron-4-340B at full width (d 18432, 96 query heads on 8 KV
   heads of 192, vocab 256000) cut to 1 layer (51.6 GB of float32 weights;
   GLM-4-9B's are freed first): decode ≡ forward at head_dim 192;
8. hymba: Hymba-1.5B at full width and depth (32 layers, d 1600, 25 query
   heads on 5 KV heads of 64, Mamba heads of state 16, window 1024; 1.40 G
   float32 parameters): serve under Orloj with rmsnorm and flash launched,
   its graphs held against eager forwards, the token path (decode at a
   group of 5), decode ≡ forward over 16 tokens, an eager (8, 256)
   forward's peak memory and the replay's device time by class (the
   selective scan launched in every layer) beside one layer's Mamba branch
   and its selective scan alone; then 2 layers
   at full width: a forward of 1100 tokens against 1100 decode steps across
   the 1024-slot ring's wrap;
9. xlstm: xLSTM-1.3B at full width and depth (48 blocks, d 2048, 4 heads of
   512, one sLSTM block in 8), whose model path launches none of the
   kernels: decode ≡ forward, its token path through the engine (the
   decode kernel at head size 512, every step's replay held against the
   plain version on the graph's inputs), the (8, 256) forward's seconds, device operations and idle
   share, and one sLSTM cell's 256 sequential steps;
10. internvl2: InternVL2-1B at full width and depth (24 layers, d 896, 14
   query heads on 2 KV heads): logits over 256 patch embeddings and 64
   tokens, decode ≡ forward (flash and decode at a group of 7), and one
   layer with a 512-word vocabulary against the CPU, image prefix included;
11. musicgen: MusicGen-large at full width and depth (48 layers, d 2048, 32
   heads), float32 weights computing in bfloat16 from the audio frames:
   logits over 256 frames, decode ≡ forward over a bfloat16 cache (to 5e-2
   of the largest logit);
12. engine-smoke: the paper's real-engine grid (``grid.engine_smoke()``:
   bimodal, ORLOJ against Nexus at SLO 1.5 and 5) through the port's
   ``runner.run_specs`` on the card, on the toy ``orloj_gpt`` (flash at
   head_dim 16) and then on ``engine:orloj_gpt_paper`` (full width, flash
   at 64): per cell the finish rate, the sim twin's, the drift, the batch
   MAPE, the batches, the profiled c0/c1 and the flash launches of its
   window; each model's graphs held against eager forwards (the toy at
   (1, 32) and (4, 32)); the artifact under ``build/``, the drift report
   per model, and every flash call of one cell of each model, served again
   on a new engine (each shape's eager warm-up), held against the plain
   version;
13. training (``repro_torch.launch.train.train``, the CLI's body, whose
   step is a ``TrainProgram``: step 1 eager, every later step a replay of
   its CUDA graph): T1, full-width orloj_gpt 50 steps at (8, 256), the loss
   must improve; T2, GLM-4-9B at full width cut to 4 layers with its
   recomputation and loss chunks of 512, 5 steps at (2, 1024); each with
   its ms/step, the corpus's host share, peak memory, launches and one
   profiled replay (busy, idle); then the same loop with its step eager
   from the same weights and batches: first and median ms/step eager →
   graphed, peak and reserved memory, and the two loops' losses
   (bit-identical, or within 1e-4 relative).  T3 and T4: one train step on
   the card, replayed from the program's graph on the drawn weights,
   against the CPU (loss, gradient norm, every gradient leaf, the
   parameters after AdamW) at GLM-4's widths cut to 1 layer and a 512-word
   vocabulary, full-width orloj_gpt, Arctic ``.reduced(n_experts=16)`` and
   Hymba ``.reduced()``;
14. dryrun: ``repro_torch.launch.dryrun.run_one`` on the 16×16 production
   mesh (a fake process group of 256 ranks; the DTensors' shards are meta
   tensors, so nothing runs on the card) for GLM-4-9B × train_4k, Arctic ×
   decode_32k and Nemotron-4-340B × prefill_32k: each result row, its
   per-device FLOPs, bytes, collective bytes and memory, and whether its
   peak fits 80 GB; fails if one does not lower;
15. placement: the 1-device debug mesh (an NCCL group of one); GLM-4-9B at
   full width cut to 4 layers (T2's model) with its parameters in DTensors
   by ``param_specs`` (their shards alias the plain tensors): one step's
   loss and gradients at (2, 1024) and six decode steps, each against the
   same on plain tensors (T3's tolerances; logits to 1e-4 of the largest),
   flash, its backward, RMSNorm, its backward and decode launched under
   DTensor; then Arctic ``.reduced(n_experts=16)`` (T4's), which launches
   the gates and their backward;
16. memory: on the same mesh the dry-run's predicted peak of one train step
   of T1 and of T2 against ``max_memory_allocated`` over the same step on
   the card (from what was allocated before its parameters), held to 10%;
17. op dispatch: the host's microseconds per call of each forward kernel
   through its ``torch.library`` operator against the raw ctypes launcher;
18. one line per kernel and shape with the kernel's ratios to SDPA, to
   their plain versions and to their bounds, then the ``kernels`` line
   (JSON): launches on the main paths, kernel, plain and library times,
   and the least time the card could take (for flash also on the tensor
   cores: ``tc_bound_ms``, the backward's ``bound_ms`` only there; the
   forward with its LSE output off and on,
   ``lse``; for the gating also its own duration from the profiler,
   ``own_ms``, and both times at T = 8, 32, 256 and 2048, ``by_T``; for
   the backwards autograd through the plain version and the library's
   backward, each captured in a CUDA graph and replayed, as the kernels
   are, and each launch's own duration; the flash backward also in bf16
   and at Arctic's shape, with its GQA split count).

Phases 4 and 5 also run decode ≡ forward: a prompt of a few tokens for 2
rows through ``Model.logits`` and the same tokens one by one through
``init_cache`` (of the logits' type: float32, bfloat16 for MusicGen) and
``decode_step``, held to LOGITS_TOL; phases 6 to 11 run it for their
models.  Every kernel call of those runs, and of the forwards of phases 10
and 11, is held against its plain version on the call's own inputs as it
returns, at the phase 3 tolerances (one line per kernel and shape;
``path_calls_held`` and ``path_max_abs_err`` in the ``kernels`` line).

The launch counters are set to 0 just before each serve, token, forward,
decode ≡ forward and training path and each engine-smoke cell, and read
just after; the line's launches are their sums.  A graph's capture counts
no launch and each replay its captured ones (``ops.captured_launches``),
so a window counts launches on the card.  Recomputation (T2) runs
each block's forward again in the backward, so T2's forward launches are
twice its backward ones.  Every serving path checks that no parameter
requires grad (the raw launchers refuse such inputs under grad mode).  The
holds of the paths' kernel calls run inside the windows and launch no
kernel; the card-vs-CPU comparisons and the timings run outside them.
Each phase prints its seconds.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32
# FLOP/s outside the tensor cores, and the dense tensor-core rates in TF32
# and bf16.  `bound_ms` counts float32 work at the SIMT rate (as since the
# port began); the flash kernel's `tc_bound_ms` counts it on the tensor
# cores, three TF32 passes per float32 product, as the flash backward's
# `bound_ms` does; decode's `bound_ms` prices its work on the route that
# the kernel's plan takes.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
F32_TOL, BF16_TOL = 1e-4, 2e-2
ROW_TOL = 1e-5  # RMSNorm and the gates in float32: one row sum in another order
LOGITS_TOL = 1e-3  # card vs CPU, float32 layers and a d-wide head
BF16_MODEL_TOL = 5e-2  # a bfloat16 model, relative to its largest logit (test_arch_smoke's bound)
N_REQUESTS, N_TOKEN_REQUESTS = 100, 32
ARCTIC_LAYERS = 1  # 56.3 GB of float32 weights per layer: one fits the 80 GB card
PROMPT = 8  # tokens of each row in decode ≡ forward


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------ timing
def time_ms(fn, reps: int = 20, graphs: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``graphs`` times between CUDA events.  The graph removes the
    host's launch cost, so the number is the card's."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):  # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(graphs):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * graphs)


def own_ms(fn, kernel: str, calls: int = 20) -> float:
    """Mean device duration (ms) of the kernel whose name holds ``kernel``,
    over ``calls`` calls of ``fn``, from the profiler's CUPTI kernel
    records: the kernel's own run, without the launch interval that each
    call timed by :func:`time_ms` also holds.  The mean is over the kernel
    records the profiler kept (it may drop one of a run).  The run has a
    warm-up step, whose records are discarded, before the measured one: on
    some hosts a profile that starts cold keeps only 6 to 9 records of 20.
    Fails if the measured step kept fewer than half."""
    return own_ms_each(fn, (kernel,), calls)[kernel]


def own_ms_each(fn, kernels, calls: int = 20) -> dict[str, float]:
    """:func:`own_ms` of each kernel of ``kernels`` (each launched once a
    call of ``fn``), from one profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):  # the warm-up step, then the measured one
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    res = {}
    for kernel in kernels:
        found = [e for e in events if kernel in e.key]
        n = sum(e.count for e in found)
        if not calls / 2 <= n <= calls:
            raise SystemExit(f"the profiler recorded {n} {kernel} kernels for {calls} calls")
        res[kernel] = sum(e.device_time_total for e in found) / n / 1e3
    return res


def grad_ms(forward, ins, dout) -> float:
    """Device time of one backward through autograd, as :func:`time_ms`
    times a kernel: ``forward(*ins)`` runs once on a side stream, then 20
    calls of ``torch.autograd.grad`` of its output for ``dout`` are captured
    in a CUDA graph on that stream (autograd runs each backward operation
    on its forward's stream) and replayed 5 times between CUDA events.  The
    host's launches are not in the number."""
    import torch

    reps, graphs = 20, 5

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = forward(*ins)
        for _ in range(3):  # warm-up outside the capture
            torch.autograd.grad(out, ins, dout, retain_graph=True)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for _ in range(reps):
            torch.autograd.grad(out, ins, dout, retain_graph=True)
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(graphs):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * graphs)


def flash_work(q, k, lengths, causal: bool, window: int, prefix: int = 0) -> tuple[int, int]:
    """(bytes, FLOPs) of flash attention on these inputs: q, k, v read once
    and the output written once, and 4·hd FLOPs for each (query, key) pair
    the masks let through (q·k and p·v; the keys below ``prefix`` pass the
    window)."""
    import torch

    b, h, s, hd = q.shape
    kv = k.shape[1]
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= (j > i - window) | (j < prefix)
    lens = torch.full((b,), s) if lengths is None else lengths.cpu().clamp(0, s)
    pairs = sum(int(mask[:, : int(L)].sum()) for L in lens) * h
    elt = q.element_size()
    nbytes = elt * (2 * b * h * s * hd + 2 * b * kv * s * hd) + (0 if lengths is None else 4 * b)
    return nbytes, 4 * hd * pairs


def flash_bound(q, k, lengths, causal: bool, window: int, prefix: int = 0) -> tuple[float, str]:
    """Least time (ms) with the float32 work at the SIMT rate."""
    return _bound(*flash_work(q, k, lengths, causal, window, prefix))


def flash_tc_bound(q, k, lengths, causal: bool, window: int, prefix: int = 0) -> tuple[float, str]:
    """Least time (ms) with the work on the tensor cores: float32 as three
    TF32 passes (the kernel's split-TF32 route), bf16 as one."""
    import torch

    nbytes, flops = flash_work(q, k, lengths, causal, window, prefix)
    if q.dtype == torch.float32:
        return _bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    return _bound(nbytes, flops, BF16_FLOP_PER_S)


def decode_bound(q, k_cache, valid_len, route: str) -> tuple[float, str]:
    """Least time (ms) for decode attention on these inputs: q and the
    output once, the valid part of the K/V cache once (in the cache's own
    type), and 4·hd FLOPs per (query head, valid key), at the rate of the
    kernel's ``route`` (``decode_plan``'s): the SIMT and head-size-512
    routes at the float32 SIMT rate; the tensor cores over a float32 cache
    as three TF32 passes, over a bf16 cache as bf16 products, one for each
    bf16 part of the queries' type (three of float32, one of bf16)."""
    import torch

    b, h, hd = q.shape
    kv = k_cache.shape[1]
    valid = int(valid_len.clamp(0, k_cache.shape[2]).sum())
    nbytes = q.element_size() * 2 * b * h * hd + k_cache.element_size() * 2 * valid * kv * hd + 4 * b
    flops = 4 * hd * valid * h
    if route != "tensor_cores":
        return _bound(nbytes, flops)
    if k_cache.dtype == torch.float32:
        return _bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    return _bound(nbytes, (3 if q.dtype == torch.float32 else 1) * flops, BF16_FLOP_PER_S)


def scan_bound(x, n_state: int) -> tuple[float, str]:
    """Least time (ms) of a selective scan over x (B, S, E): x, Δ and the
    gate's input read once, B and C ((B, S, N) each) read once and y written
    once, at the HBM rate (``orloj_bench/families/hymba.py``'s
    ``scan_bytes``)."""
    b, s, e = x.shape
    return _bound(x.element_size() * (4 * b * s * e + 2 * b * s * n_state), 0.0)


def rmsnorm_bound(x) -> tuple[float, str]:
    """x read and the output written once, the float32 scale once; ~4
    FLOPs per element (square, sum, two products)."""
    t, d = x.shape
    return _bound(2 * t * d * x.element_size() + 4 * d, 4 * t * d)


def gating_bound(logits, k: int) -> tuple[float, str]:
    """The float32 logits read once, the (T, k) float32 gates and int32 ids
    written once; per logit a subtraction, an exp, a division and k
    comparisons."""
    t, e = logits.shape
    return _bound(4 * t * e + 8 * t * k, (3 + k) * t * e)


def flash_bwd_bound(q, k, lengths, causal: bool, window: int) -> tuple[float, str]:
    """Least time (ms) of the flash backward on these inputs: q, k, v, the
    output, its gradient and the float32 LSE read once, dq, dk, dv written
    once (4 tensors of q's shape, 4 of k's); five products of hd
    multiply-adds per (query, key) pair the masks let through (the
    recomputed q·k, dO·v, and the dV, dK, dQ products), 10·hd FLOPs, on the
    tensor cores, the kernel's route (float32 as three TF32 passes)."""
    import torch

    b, h, s, hd = q.shape
    _, fwd_flops = flash_work(q, k, lengths, causal, window)
    pairs = fwd_flops // (4 * hd)
    nbytes = q.element_size() * (4 * b * h * s * hd + 4 * b * k.shape[1] * s * hd) + 4 * b * h * s
    flops = 10 * hd * pairs
    if q.dtype == torch.float32:
        return _bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    return _bound(nbytes, flops, BF16_FLOP_PER_S)


def rmsnorm_bwd_bound(x) -> tuple[float, str]:
    """x and dy read, dx written, the float32 scale read and dscale written
    once; ~10 FLOPs per element (the two sums, dx, dscale's term)."""
    t, d = x.shape
    return _bound(3 * t * d * x.element_size() + 8 * d, 10 * t * d)


def gating_bwd_bound(logits, k: int) -> tuple[float, str]:
    """The logits read and their gradient written once, the (T, k) int32 ids
    and float32 gate gradients read once; per logit the softmax again (a
    subtraction, an exp, a division) and p·(dp − c), ~6 FLOPs."""
    t, e = logits.shape
    return _bound(2 * logits.element_size() * t * e + 8 * t * k, 6 * t * e)


def _bound(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the FLOPs' at
    ``flop_per_s``, in ms, and which it was."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_ok(out, want) -> tuple[float, bool]:
    """The max abs error of an attention kernel's output against its plain
    version's, and whether it is within tolerance.  A float32 output (float32
    queries, over a float32 or a bf16 cache: both sides compute in float32 on
    the same values): F32_TOL.  A bf16 output (bf16 inputs): BF16_TOL (one
    bf16 rounding), or, where it is of magnitude 4 or more, one bf16 step of
    the value (0.03125 in [4, 8)): two roundings of nearly equal float32
    values may lie a step apart."""
    import torch

    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    if out.dtype != torch.bfloat16:
        return err, math.isfinite(err) and err <= F32_TOL
    step = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
    bound = torch.maximum(torch.full_like(diff, BF16_TOL), step)
    return err, math.isfinite(err) and bool((diff <= bound).all())


# ------------------------------------------------------------ phases
def phase_card() -> str:
    import torch

    from repro_torch.kernels import _build

    line = card_line()
    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout
    release = next(ln for ln in nvcc.splitlines() if "release" in ln)
    log(line)
    log(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {release.strip()}")
    return line


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    log(f"build: {', '.join(logs)} with nvcc for sm_90a in {secs:.2f} s")
    for out in logs.values():
        for fn, props in ptxas_report(out):
            log(f"ptxas: {fn}: {props}")


def ptxas_report(out: str) -> list[tuple[str, str]]:
    """(kernel<template arguments>, registers, spills and static shared
    memory) for each entry function in an ``-Xptxas -v`` log."""
    import re

    report, name, spill = [], None, ""
    for ln in out.splitlines():
        # A type named twice is mangled the second time as a substitution
        # (S_, S0_, ...): bf16 queries over a bf16 cache read "13__nv_bfloat16S2_".
        m = re.search(r"Function properties for .*?\d([a-z_]+_kernel(?:_wgmma)?)(?:I((?:f|13__nv_bfloat16|S\d*_)*)"
                      r"((?:L[a-z]\d+E)*))?", ln)
        if m:
            types: list[str] = []
            for t in re.findall(r"f|13__nv_bfloat16|S\d*_", m.group(2) or ""):
                types.append("float" if t == "f" else "bf16" if t[0] == "1" else types[-1])
            args = [*types, *re.findall(r"L[a-z](\d+)E", m.group(3) or "")]
            name = f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            report.append((name, f"{m.group(1)} registers, {spill}, static smem "
                                 f"{smem.group(1) if smem else 0} B"))
            name = None
    return report


def _randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_kernels_vs_plain() -> dict[str, float]:
    """Every case of the five forward kernels against its plain version;
    returns the error at each kernel's main-path shape (``arctic_*``: at
    Arctic's)."""
    import torch

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import selective_scan as sc

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    main_err: dict[str, float] = {}
    failures = []

    flash_cases = [
        ("main path (8,12,256,64) f32 causal", 8, 12, 12, 256, 64, f32, None, 0, 0.0),
        ("GQA (2,8->2,256,64) f32", 2, 8, 2, 256, 64, f32, None, 0, 0.0),
        ("bf16 (8,12,256,64)", 8, 12, 12, 256, 64, bf16, None, 0, 0.0),
        ("ragged S=300 (2,12,300,64) f32", 2, 12, 12, 300, 64, f32, None, 0, 0.0),
        ("lengths [256,70,17,1,200,128,64,33] f32", 8, 12, 12, 256, 64, f32,
         [256, 70, 17, 1, 200, 128, 64, 33], 0, 0.0),
        ("window 64 (2,12,256,64) f32", 2, 12, 12, 256, 64, f32, None, 64, 0.0),
        ("arctic (8,56->8,256,128) f32 causal", 8, 56, 8, 256, 128, f32, None, 0, 0.0),
        ("smallest bucket S=32 (8,12,32,64) f32", 8, 12, 12, 32, 64, f32, None, 0, 0.0),
        ("S=1 (3,4->2,1,64) f32", 3, 4, 2, 1, 64, f32, None, 0, 0.0),
        ("GQA 7:1 hd 128 lengths [256,131] window 96 f32", 2, 14, 2, 256, 128, f32, [256, 131], 96, 0.0),
        ("bf16 GQA 7:1 hd 128 (2,14->2,256,128)", 2, 14, 2, 256, 128, bf16, None, 0, 0.0),
        ("glm4 GQA 16:1 (2,32->2,256,128) f32", 2, 32, 2, 256, 128, f32, None, 0, 0.0),
        ("glm4 decode ≡ forward (2,32->2,8,128) f32", 2, 32, 2, 8, 128, f32, None, 0, 0.0),
        ("arctic decode ≡ forward (2,56->8,8,128) f32", 2, 56, 8, 8, 128, f32, None, 0, 0.0),
        ("softcap 2 (2,8->2,256,64) lengths [256,100] f32", 2, 8, 2, 256, 64, f32, [256, 100], 0, 2.0),
        ("softcap 2 smallest bucket (4,4,32,64) f32", 4, 4, 4, 32, 64, f32, None, 0, 2.0),
        ("softcap 2 bf16 (2,8->2,256,128)", 2, 8, 2, 256, 128, bf16, None, 0, 2.0),
        # head_dim 16: the engine-smoke toy (B <= 4, 4 heads, its buckets 8 ... 32)
        ("toy hd 16 S=8 (4,4,8,16) f32", 4, 4, 4, 8, 16, f32, None, 0, 0.0),
        ("toy hd 16 S=16 (4,4,16,16) f32", 4, 4, 4, 16, 16, f32, None, 0, 0.0),
        ("toy hd 16 S=24 lengths [24,9,1,17] f32", 4, 4, 4, 24, 16, f32, [24, 9, 1, 17], 0, 0.0),
        ("toy hd 16 S=32 (4,4,32,16) f32", 4, 4, 4, 32, 16, f32, None, 0, 0.0),
        ("toy hd 16 S=24 (2,4,24,16) bf16", 2, 4, 4, 24, 16, bf16, None, 0, 0.0),
        ("hd 16 (8,12->4,256,16) lengths f32", 8, 12, 4, 256, 16, f32,
         [256, 70, 17, 1, 200, 128, 64, 33], 0, 0.0),
        ("hd 16 bf16 (2,8->2,300,16)", 2, 8, 2, 300, 16, bf16, None, 0, 0.0),
        ("softcap 2 hd 16 (2,4,32,16) f32", 2, 4, 4, 32, 16, f32, None, 0, 2.0),
        # head_dim 192: Nemotron-4-340B
        ("nemotron (8,96->8,256,192) f32 causal", 8, 96, 8, 256, 192, f32, None, 0, 0.0),
        ("nemotron (8,96->8,256,192) bf16", 8, 96, 8, 256, 192, bf16, None, 0, 0.0),
        ("nemotron decode ≡ forward (2,96->8,8,192) f32", 2, 96, 8, 8, 192, f32, None, 0, 0.0),
        ("hd 192 ragged S=300 lengths [300,131] f32", 2, 8, 2, 300, 192, f32, [300, 131], 0, 0.0),
        ("hd 192 smallest bucket (4,4,32,192) bf16", 4, 4, 4, 32, 192, bf16, None, 0, 0.0),
        ("softcap 2 hd 192 (2,8->2,256,192) f32", 2, 8, 2, 256, 192, f32, [256, 100], 0, 2.0),
        # the zoo's SSM and frontend models: Hymba (group 5, window 1024), InternVL2
        # (group 7), MusicGen (bf16, MHA)
        ("hymba (8,25->5,256,64) f32", 8, 25, 5, 256, 64, f32, None, 1024, 0.0),
        ("hymba window 1024 (1,25->5,2048,64) f32", 1, 25, 5, 2048, 64, f32, None, 1024, 0.0),
        ("hymba ring wrap (1,25->5,1100,64) lengths [1100] f32", 1, 25, 5, 1100, 64, f32, [1100], 1024, 0.0),
        # Hymba-1.5B's 128 meta tokens, seen through every window (the
        # flash kernel's prefix): its largest served batch, ragged rows, bf16
        ("hymba prefix 128 window 1024 (4,25->5,2176,64) f32", 4, 25, 5, 2176, 64, f32, None, 1024, 0.0, 128),
        ("hymba prefix 128 window 1024 (2,25->5,1300,64) lengths [1300,700] f32", 2, 25, 5, 1300, 64, f32,
         [1300, 700], 1024, 0.0, 128),
        ("prefix 16 window 48 (2,8->2,200,64) bf16", 2, 8, 2, 200, 64, bf16, None, 48, 0.0, 16),
        ("prefix 40 window 32 hd 192 (1,4->2,160,192) f32", 1, 4, 2, 160, 192, f32, None, 32, 0.0, 40),
        ("internvl2 (8,14->2,256,64) f32", 8, 14, 2, 256, 64, f32, None, 0, 0.0),
        ("internvl2 prefix + tokens (2,14->2,320,64) f32", 2, 14, 2, 320, 64, f32, None, 0, 0.0),
        ("musicgen (8,32,256,64) bf16", 8, 32, 32, 256, 64, bf16, None, 0, 0.0),
        # the wgmma route at each head size and type, at one and two
        # warpgroups, at groups that do not divide a block's rows (6, 48);
        # the mma_sync route is Nemotron's float32 cases above (head size 192)
        ("wgmma hd 32 (8,8->8,256,32) f32 lengths", 8, 8, 8, 256, 32, f32,
         [256, 70, 17, 1, 200, 128, 64, 33], 0, 0.0),
        ("wgmma hd 32 bf16 (8,8->2,130,32) window 40", 8, 8, 2, 130, 32, bf16, None, 40, 0.0),
        ("wgmma hd 16 bf16 g 4 (8,16->4,256,16) lengths", 8, 16, 4, 256, 16, bf16,
         [256, 70, 17, 1, 200, 128, 64, 33], 0, 0.0),
        ("wgmma hd 64 bf16 g 7 (8,14->2,256,64) lengths window 100", 8, 14, 2, 256, 64, bf16,
         [256, 70, 17, 1, 200, 128, 64, 33], 100, 0.0),
        ("wgmma hd 128 bf16 g 16 (8,32->2,256,128) softcap 2", 8, 32, 2, 256, 128, bf16, None, 0, 2.0),
        ("wgmma hd 192 g 12 (2,24->2,77,192) lengths window 30 bf16", 2, 24, 2, 77, 192, bf16, [77, 40], 30, 0.0),
        ("wgmma hd 128 g 48 (2,48->1,256,128) bf16 lengths", 2, 48, 1, 256, 128, bf16, [256, 100], 0, 0.0),
        ("wgmma hd 128 g 48 (2,48->1,256,128) f32 lengths", 2, 48, 1, 256, 128, f32, [256, 100], 0, 0.0),
        ("dbrx g 6 (8,48->8,256,128) f32", 8, 48, 8, 256, 128, f32, None, 0, 0.0),
        ("wgmma S=1 g 16 (2,32->2,1,128) bf16", 2, 32, 2, 1, 128, bf16, None, 0, 0.0),
        ("wgmma smallest bucket (8,12,32,64) bf16", 8, 12, 12, 32, 64, bf16, None, 0, 0.0),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, b, h, kv, s, hd, dt, lens, window, cap, *pre in flash_cases:
        prefix = pre[0] if pre else 0
        q = _randn(gen, (b, h, s, hd), dt)
        k = _randn(gen, (b, kv, s, hd), dt)
        v = _randn(gen, (b, kv, s, hd), dt)
        lt = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = fa.flash_attention_cuda(q, k, v, lt, causal=True, window=window, softcap=cap, prefix=prefix)
        want = ref.flash_attention_ref(q, k, v, lengths=lt, causal=True, window=window, softcap=cap,
                                       prefix=prefix)
        torch.cuda.synchronize()
        err, ok = _attention_ok(out, want)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        ok = ok and out.dtype == dt
        plan = fa.flash_plan(b, h, kv, s, hd, dt, window, sms)
        log(f"kernel vs plain: flash_attention {name}: max_abs_err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}; "
            f"{_plan_text(plan)}")
        if not ok:
            failures.append(f"flash_attention {name}")
        if name.startswith("main path"):
            main_err["flash_attention"] = err
        if name.startswith("arctic (8,56"):
            main_err["arctic_flash_attention"] = err
        if name.startswith("glm4 GQA 16:1"):
            main_err["glm4_flash_attention"] = err
        if name.startswith("toy hd 16 S=32"):
            main_err["toy_flash_attention"] = err
        if name.startswith("nemotron (8,96->8,256,192) f32"):
            main_err["nemotron_flash_attention"] = err
        for model, start in (("hymba", "hymba (8"), ("hymba_window", "hymba window 1024"),
                             ("hymba_prefix", "hymba prefix 128 window 1024 (4"),
                             ("internvl2", "internvl2 (8"), ("musicgen", "musicgen (8")):
            if name.startswith(start):
                main_err[f"{model}_flash_attention"] = err

    decode_cases = [
        ("main path (8,12,256,64) f32", 8, 12, 12, 256, 64, None),
        ("S=300 f32", 8, 12, 12, 300, 64, None),
        ("valid_len 0 rows [0,77,0,256,5,0,1,128] f32", 8, 12, 12, 256, 64, [0, 77, 0, 256, 5, 0, 1, 128]),
        ("arctic (8,56->8,256,128) f32", 8, 56, 8, 256, 128, None),
        ("g 2 valid_len [0,256,31,33,96,97,128,200] f32", 8, 16, 8, 256, 128, [0, 256, 31, 33, 96, 97, 128, 200]),
        ("g 4 (8,32->8,256,128) f32", 8, 32, 8, 256, 128, None),
        ("g 7 valid_len [0,256,7,64,65,128,191,1] f32", 8, 56, 8, 256, 128, [0, 256, 7, 64, 65, 128, 191, 1]),
        ("g 8 (4,32->4,256,64) f32", 4, 32, 4, 256, 64, None),
        ("g 7 ragged S=300 (2,56->8,300,128) f32", 2, 56, 8, 300, 128, [300, 0]),
        ("S=7 g 8 (2,16->2,7,64) f32", 2, 16, 2, 7, 64, [7, 0]),
        ("cache shorter than one split (1,8->1,512,128) valid 20 f32", 1, 8, 1, 512, 128, [20]),
        ("g 7 bf16 (8,56->8,256,128)", 8, 56, 8, 256, 128, None),
        ("glm4 g 16 (8,32->2,256,128) valid_len [0,256,31,33,96,97,128,200] f32", 8, 32, 2, 256, 128,
         [0, 256, 31, 33, 96, 97, 128, 200]),
        ("granite MQA g 48 (4,48->1,256,128) valid_len [256,0,77,255] f32", 4, 48, 1, 256, 128, [256, 0, 77, 255]),
        ("granite MQA g 48 S=4096 (4,48->1,4096,128) f32", 4, 48, 1, 4096, 128, None),
        ("f32 q, bf16 cache: granite MQA g 48 S=4096 (4,48->1,4096,128) valid_len [4096,0,1000,4095]", 4, 48, 1,
         4096, 128, [4096, 0, 1000, 4095]),
        ("g 16 S=7 (2,32->2,7,128) valid_len [7,3] f32", 2, 32, 2, 7, 128, [7, 3]),
        ("dbrx g 6 (8,48->8,256,128) f32", 8, 48, 8, 256, 128, None),
        ("f32 q, bf16 cache: g 16 S=4096 (glm4, 8,32->2,4096,128)", 8, 32, 2, 4096, 128, None),
        ("f32 q, bf16 cache: g 16 S=32768 (glm4, 8,32->2,32768,128)", 8, 32, 2, 32768, 128, None),
        ("g 16 bf16 S=4096 (glm4, 8,32->2,4096,128)", 8, 32, 2, 4096, 128, None),
        ("g 16 decode ≡ forward (2,32->2,8,128) valid_len [1,8] f32", 2, 32, 2, 8, 128, [1, 8]),
        ("g 16 timed step B 1 (1,32->2,256,128) valid_len [256] f32", 1, 32, 2, 256, 128, [256]),
        ("f32 q, bf16 cache: glm4 ragged S=300 valid_len [300,0,1,299,33,64,150,0]", 8, 32, 2, 300, 128,
         [300, 0, 1, 299, 33, 64, 150, 0]),
        ("f32 q, bf16 cache: full (8,12,256,64)", 8, 12, 12, 256, 64, [256] * 8),
        ("f32 q, bf16 cache: S=7 (3,4->2,7,32) valid_len [7,0,3]", 3, 4, 2, 7, 32, [7, 0, 3]),
        ("softcap 2 (2,8->2,256,64) valid_len [256,40] f32", 2, 8, 2, 256, 64, [256, 40]),
        ("softcap 2 f32 q, bf16 cache: glm4 (8,32->2,256,128)", 8, 32, 2, 256, 128,
         [256, 0, 5, 64, 250, 129, 1, 256]),
        # head_dim 16 (half-warps own a key's 16 dims) and 192 (6 dims a lane)
        ("toy hd 16 (4,4,32,16) f32", 4, 4, 4, 32, 16, None),
        ("hd 16 g 4 S=7 (3,8->2,7,16) valid_len [7,0,3] f32", 3, 8, 2, 7, 16, [7, 0, 3]),
        ("hd 16 bf16 (4,4,300,16) valid_len [300,1,0,33]", 4, 4, 4, 300, 16, [300, 1, 0, 33]),
        ("f32 q, bf16 cache: hd 16 g 8 (8,16->2,256,16)", 8, 16, 2, 256, 16,
         [0, 256, 31, 33, 96, 97, 128, 200]),
        ("softcap 2 hd 16 (2,4,64,16) valid_len [64,13] f32", 2, 4, 4, 64, 16, [64, 13]),
        ("nemotron g 12 (8,96->8,256,192) f32", 8, 96, 8, 256, 192, None),
        ("f32 q, bf16 cache: nemotron g 12 (8,96->8,256,192)", 8, 96, 8, 256, 192,
         [256, 0, 5, 64, 250, 129, 1, 256]),
        ("nemotron g 12 bf16 (2,96->8,256,192) valid_len [255,31]", 2, 96, 8, 256, 192, [255, 31]),
        ("hd 192 g 1 (2,8->8,1000,192) valid_len [1000,3] f32", 2, 8, 8, 1000, 192, [1000, 3]),
        ("softcap 2 hd 192 (2,8->2,256,192) valid_len [256,40] f32", 2, 8, 2, 256, 192, [256, 40]),
        ("hymba g 5: f32 q, bf16 cache: 1024-slot ring (8,25->5,1024,64)", 8, 25, 5, 1024, 64, [1024] * 8),
        ("hymba g 5 (8,25->5,1024,64) valid_len [1024,0,1,1023,512,64,65,1000] f32", 8, 25, 5, 1024, 64,
         [1024, 0, 1, 1023, 512, 64, 65, 1000]),
        ("internvl2 g 7 (8,14->2,256,64) f32", 8, 14, 2, 256, 64, None),
        ("internvl2 g 7: f32 q, bf16 cache (8,14->2,256,64)", 8, 14, 2, 256, 64, [256, 0, 5, 64, 250, 129, 1, 256]),
        ("musicgen g 1 bf16 (8,32->32,256,64)", 8, 32, 32, 256, 64, None),
        # head_dim 512: xLSTM-1.3B's token path (4 query heads on 4 KV heads, float32)
        ("xlstm hd 512 g 1 (8,4->4,256,512) f32", 8, 4, 4, 256, 512, None),
        ("hd 512 g 1 ragged S=1000 valid_len [1000,0,3] f32", 3, 4, 4, 1000, 512, [1000, 0, 3]),
    ]
    for name, b, h, kv, s, hd, valid in decode_cases:
        # The name says the types: "f32 q, bf16 cache", else one type (bf16
        # where it says so); "softcap 2" caps the scores at 2.
        dt = bf16 if "bf16" in name and "f32 q" not in name else f32
        cdt = bf16 if "bf16" in name else f32
        cap = 2.0 if "softcap 2" in name else 0.0
        q = _randn(gen, (b, h, hd), dt)
        kc = _randn(gen, (b, kv, s, hd), cdt)
        vc = _randn(gen, (b, kv, s, hd), cdt)
        if valid is None:
            vl = torch.randint(1, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
        else:
            vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
        out = dec.decode_attention_cuda(q, kc, vc, vl, softcap=cap)
        want = ref.decode_attention_ref(q, kc, vc, vl, softcap=cap)
        torch.cuda.synchronize()
        # Under float32 queries both sides compute in float32 on the same
        # cache values: F32_TOL whatever the cache's type.
        err, ok = _attention_ok(out, want)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        ok = ok and out.dtype == dt and bool((out[vl == 0] == 0).all())
        log(f"kernel vs plain: decode_attention {name}: max_abs_err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"decode_attention {name}")
        if name.startswith("main path"):
            main_err["decode_attention"] = err
        if name.startswith("arctic"):
            main_err["arctic_decode_attention"] = err
        if name.startswith("glm4"):
            main_err["glm4_decode_attention"] = err
        if name.startswith("f32 q, bf16 cache: glm4"):
            main_err["glm4_bf16_cache_decode_attention"] = err
        if name.startswith("toy hd 16"):
            main_err["toy_decode_attention"] = err
        if name.startswith("nemotron g 12 (8"):
            main_err["nemotron_decode_attention"] = err
        for model in ("hymba", "internvl2", "musicgen"):
            if name.startswith(f"{model} g ") and ("bf16" in name) == (model != "internvl2"):
                main_err[f"{model}_decode_attention"] = err
        if name.startswith("xlstm hd 512"):
            main_err["xlstm_decode_attention"] = err
        for key, prefix in (("glm4_4096", "f32 q, bf16 cache: g 16 S=4096"),
                            ("glm4_32768", "f32 q, bf16 cache: g 16 S=32768"),
                            ("granite", "granite MQA g 48 S=4096"), ("dbrx", "dbrx g 6")):
            if name.startswith(prefix):
                main_err[f"{key}_decode_attention"] = err
    failures += _flash_bit_identity(gen)
    failures += _decode_bit_identity(gen)

    rms_cases = [
        ("main path (2048,7168) f32", 2048, 7168, f32),
        ("(2048,7168) bf16", 2048, 7168, bf16),
        ("ragged T=300 (300,7168) f32", 300, 7168, f32),
        ("(64,896) f32", 64, 896, f32),
        ("(7,1024) f32", 7, 1024, f32),
        ("hymba (2048,1600) f32", 2048, 1600, f32),
    ]
    for name, t, d, dt in rms_cases:
        x = _randn(gen, (t, d), dt) * 3
        scale = _randn(gen, (d,), f32)
        out = rms.rmsnorm_cuda(x, scale, eps=1e-5)
        want = ref.rmsnorm_ref(x, scale, 1e-5)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dt == bf16 else ROW_TOL
        # rtol = atol = tol: a bf16 output of magnitude ~10 is one bf16 step
        # (0.06) apart when the two float32 values straddle a rounding boundary.
        ok = out.dtype == dt and bool(torch.isclose(out.float(), want.float(), rtol=tol, atol=tol).all())
        log(f"kernel vs plain: rmsnorm {name}: max_abs_err {err:.3e} (rtol = atol = {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"rmsnorm {name}")
        if name.startswith("main path"):
            main_err["rmsnorm"] = err
        if name.startswith("hymba"):
            main_err["hymba_rmsnorm"] = err

    tie = torch.zeros((6, 16), device="cuda")
    tie[1] = 3.0  # a row of equal logits
    tie[2, [3, 9, 12]] = 5.0  # three equal maxima
    tie[3, [15, 0]] = 2.0
    tie[4] = torch.arange(16, device="cuda") % 4  # every value four times
    tie[5, ::2] = -1.0
    neg_inf = _randn(gen, (4, 16), f32)
    neg_inf[0, 1:] = -math.inf  # one finite logit: fifteen zero probabilities, tied
    neg_inf[1, ::2] = -math.inf
    neg_inf[2, :14] = -math.inf
    neg_inf[3, [3, 7]] = -math.inf
    unaligned = torch.empty(64 * 128 + 1, device="cuda")[1:].view(64, 128)
    unaligned.copy_(_randn(gen, (64, 128), f32) * 2)  # rows off 16 bytes: the scalar loads
    gating_cases = [
        ("main path (2048,128) k 2", _randn(gen, (2048, 128), f32) * 2, 2),
        ("(256,16) k 4", _randn(gen, (256, 16), f32) * 2, 4),
        ("(256,8) k 1", _randn(gen, (256, 8), f32) * 2, 1),
        ("ties (6,16) k 4", tie, 4),
        ("T=1 (1,128) k 2", _randn(gen, (1, 128), f32) * 2, 2),
        ("T=7 (7,128) k 2", _randn(gen, (7, 128), f32) * 2, 2),
        ("T=33 (33,128) k 2", _randn(gen, (33, 128), f32) * 2, 2),
        ("E=3 (64,3) k 2", _randn(gen, (64, 3), f32) * 2, 2),
        ("E=130 (64,130) k 4", _randn(gen, (64, 130), f32) * 2, 4),
        ("E=256 (2048,256) k 2", _randn(gen, (2048, 256), f32) * 2, 2),
        ("k == E (64,8) k 8", _randn(gen, (64, 8), f32) * 2, 8),
        ("k == E (64,3) k 3", _randn(gen, (64, 3), f32) * 2, 3),
        ("bf16 (2048,128) k 2", _randn(gen, (2048, 128), bf16) * 2, 2),
        ("bf16 E=130 (33,130) k 2", _randn(gen, (33, 130), bf16) * 2, 2),
        ("-inf logits (4,16) k 4", neg_inf, 4),
        ("rows off 16 bytes (64,128) k 2", unaligned, 2),
    ]
    for name, logits, k in gating_cases:
        gates, ids = gating.moe_gating_cuda(logits, k)
        wg, wi = ref.moe_gating_ref(logits, k)
        torch.cuda.synchronize()
        err = (gates - wg).abs().max().item()
        ids_equal = torch.equal(ids, wi)
        ok = ids_equal and err <= ROW_TOL
        log(f"kernel vs plain: moe_gating {name}: ids equal {ids_equal}, gates max_abs_err {err:.3e} "
            f"(tol {ROW_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"moe_gating {name}")
        if name.startswith("main path"):
            main_err["moe_gating"] = err

    # The selective scan: y and the last state against the plain version
    # (one position at a time) to F32_TOL, the state written only where
    # asked and y the same bits either way.  Hymba-1.5B's served (k, 128 +
    # bucket) at inner width 3200, the narrow preset's (8, 256) at 1600, a
    # run cut in several and shapes off the tiles.
    scan_cases = [
        ("hymba_1_5b (4,2176,3200)", 4, 2176, 3200),
        ("hymba_1_5b (1,2176,3200)", 1, 2176, 3200),
        ("hymba_1_5b (8,384,3200)", 8, 384, 3200),
        ("narrow preset (8,256,1600)", 8, 256, 1600),
        ("S=1 (1,1,64)", 1, 1, 64),
        ("ragged (2,37,96)", 2, 37, 96),
        ("ragged (3,300,200)", 3, 300, 200),
    ]
    for name, b, s, e in scan_cases:
        ins = _scan_inputs(gen, b, s, e)
        y, h = sc.selective_scan_cuda(*ins, last_state=True)
        y2, none = sc.selective_scan_cuda(*ins)
        want_y, want_h = ref.selective_scan_ref(*ins)
        torch.cuda.synchronize()
        err = max((y - want_y).abs().max().item(), (h - want_h).abs().max().item())
        ok = (torch.allclose(y, want_y, rtol=F32_TOL, atol=F32_TOL)
              and torch.allclose(h, want_h, rtol=F32_TOL, atol=F32_TOL)
              and torch.equal(y, y2) and none.numel() == 0)
        log(f"kernel vs plain: selective_scan {name}: max_abs_err {err:.3e} (rtol = atol = {F32_TOL}) "
            f"{'ok' if ok else 'FAIL'}; runs {sc.scan_plan(b, s, e, sms)}")
        if not ok:
            failures.append(f"selective_scan {name}")
        if name.startswith("hymba_1_5b (4"):
            main_err["selective_scan"] = err
        if name.startswith("hymba_1_5b (1"):
            main_err["b1_selective_scan"] = err
    if failures:
        raise SystemExit(f"kernels disagree with their plain versions: {failures}")
    return main_err


def _scan_inputs(gen, b: int, s: int, e: int) -> tuple:
    """A selective scan's inputs as the model makes them: x and the gate's
    input N(0, 1), Δ = softplus(N(0, 1)/2 − 4) (about dt_bias's published
    range), B and C N(0, 1), a_log = log(1..16) plus noise, D near 1."""
    import torch

    def n(*shape):
        return _randn(gen, shape, torch.float32)

    dt = torch.nn.functional.softplus(n(b, s, e) * 0.5 - 4.0)
    a_log = torch.log(torch.arange(1, 17, dtype=torch.float32, device="cuda")) + 0.1 * n(e, 16)
    return n(b, s, e), dt, n(b, s, 16), n(b, s, 16), n(b, s, e), a_log, 1.0 + 0.1 * n(e)


# Backward kernels against autograd through the plain versions: relative
# to the largest gradient (at least 1), since a gradient sums the same
# products in other orders than the forward.  Flash attention in float32 to
# F32_TOL (its SIMT float32 sums against the plain version's matrix
# products), RMSNorm's dx and the logits' gradient to ROW_TOL (one row sum
# in another order), RMSNorm's dscale to F32_TOL (a column sum over T rows
# in another order); bf16 to BF16_TOL.
# GLM-4-9B's float32 weight products, (K, N): q and o, k and v, gate and
# up, down, and the head.
GEMM_PRODUCTS = {"q/o": (4096, 4096), "k/v": (4096, 256), "gate/up": (4096, 13696),
                 "down": (13696, 4096), "head": (4096, 151552)}
GEMM_PER_LAYER = {"q/o": 2, "k/v": 2, "gate/up": 2, "down": 1}


def _tf32_one_pass(x):
    """x rounded to TF32 (one pass's operands): to nearest, ties away from zero."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def gemm_errors(x, w, y) -> tuple[float, float, float]:
    """The kernel's, cuBLAS float32's and one TF32 pass's largest error
    against the float64 product, each over the largest |product|."""
    want = x.double() @ w.double()
    scale = want.abs().max().item()
    one = _tf32_one_pass(x).double() @ _tf32_one_pass(w).double()
    errs = tuple((got.double() - want).abs().max().item() / scale for got in (y, x @ w, one))
    del want, one
    return errs


def phase_gemm() -> dict:
    """The float32 GEMM (``kernels/gemm.py``, ``csrc/gemm.cu``) at GLM-4-9B's
    products and M 32, 128 and 256: each against the float64 product beside
    cuBLAS float32 and one TF32 pass (the kernel within 4x cuBLAS's error
    and at least 100x under one pass's), then its time by graph replay and
    its own duration beside its bound (the weight's bytes at 3.35 TB/s or
    the work at 165 TFLOP/s, three TF32 passes), the plain version's
    (``x @ w``) and ``torch.matmul``'s; two calls and a graph replayed over
    rewritten inputs bit for bit; the kernel's instruction census.  Returns
    the kernel line's entry."""
    import torch

    from repro_torch.kernels import gemm

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases, failures = [], []
    layer_ms = {m: 0.0 for m in (32, 128, 256)}
    head_ms = {}
    for name, (k, n) in GEMM_PRODUCTS.items():
        w = _randn(gen, (k, n), torch.float32) / math.sqrt(k)
        for m in (32, 128, 256):
            x = _randn(gen, (m, k), torch.float32)
            plan = gemm.gemm_plan(m, n, k, sms)
            y = gemm.gemm_cuda(x, w)
            torch.cuda.synchronize()
            err, err_f32, err_one = gemm_errors(x, w, y)
            ok = err <= 4 * err_f32 and 100 * err <= err_one
            ms = time_ms(lambda: gemm.gemm_cuda(x, w))
            own = own_ms(lambda: gemm.gemm_cuda(x, w), "gemm_kernel")
            plain = time_ms(lambda: gemm.gemm_ref(x, w))
            library = time_ms(lambda: torch.matmul(x, w))
            bound, by = gemm.bound_s(m, n, k)
            tflops = gemm.flops(m, n, k) / own / 1e9
            cases.append({"product": name, "m": m, "k": k, "n": n, "plan": _gemm_plan_text(plan),
                          "max_rel_err": err, "cublas_f32_rel_err": err_f32, "tf32_one_pass_rel_err": err_one,
                          "ms": ms, "own_ms": own, "bound_ms": bound * 1e3, "bound_by": by,
                          "plain_ms": plain, "library_ms": library, "tflops": tflops})
            log(f"gemm {name} ({m},{k})x({k},{n}) f32 [{_gemm_plan_text(plan)}]: err {err:.3e} "
                f"(cuBLAS f32 {err_f32:.3e}, one TF32 pass {err_one:.3e}) {'ok' if ok else 'FAIL'}; "
                f"{ms:.5f} ms, own {own:.5f} ms ({tflops:.1f} TFLOP/s), /bound {own / (bound * 1e3):.3f} "
                f"(bound {bound * 1e3:.5f} ms, {by}); plain {plain:.5f} ms, torch.matmul {library:.5f} ms")
            if not ok:
                failures.append(f"{name} M={m}")
            if name == "head":
                head_ms[m] = own
            else:
                layer_ms[m] += GEMM_PER_LAYER[name] * own
            del x, y
        del w
        torch.cuda.empty_cache()
    for m, ms in layer_ms.items():
        bound = sum(GEMM_PER_LAYER[nm] * gemm.bound_s(m, n, k)[0] * 1e3
                    for nm, (k, n) in GEMM_PRODUCTS.items() if nm != "head")
        log(f"gemm GLM-4-9B forward at M={m}: 40 layers x {ms:.5f} ms + head {head_ms[m]:.5f} ms = "
            f"{40 * ms + head_ms[m]:.3f} ms of products (their bounds: {40 * bound:.3f} ms + head)")
    for line in _gemm_bit_identity(gen):
        log(line)
    census = subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "scripts" / "sass_census.py"),
                             "gemm"], capture_output=True, text=True, check=True, timeout=600).stdout
    for line in census.splitlines():
        log(line)
    if failures:
        raise SystemExit(f"gemm: errors outside float32's band: {failures}")
    row = next(c for c in cases if c["product"] == "gate/up" and c["m"] == 128)
    return {"name": "gemm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/gemm.cu",
            "replaces": None, "max_rel_err": max(c["max_rel_err"] for c in cases),
            **{key: row[key] for key in ("ms", "own_ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
                                         "tflops")},
            "cases": cases}


def _gemm_plan_text(plan) -> str:
    return f"T{plan.tokens} S{plan.splits}x{plan.tiles_per_split} st{plan.stages}"


def _gemm_bit_identity(gen) -> list[str]:
    """The GEMM at a split and an unsplit plan: two calls equal bit for bit,
    and a graph of the call replayed over rewritten inputs equal to an
    eager call on them."""
    import torch

    from repro_torch.kernels import gemm

    lines = []
    for m, k, n in ((32, 4096, 256), (128, 4096, 13696), (37, 13696, 4096)):
        x = _randn(gen, (m, k), torch.float32)
        w = _randn(gen, (k, n), torch.float32)
        a, b = gemm.gemm_cuda(x, w), gemm.gemm_cuda(x, w)
        g = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            gemm.gemm_cuda(x, w)
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(g):
            out = gemm.gemm_cuda(x, w)
        x.copy_(_randn(gen, (m, k), torch.float32))
        g.replay()
        eager = gemm.gemm_cuda(x, w)
        torch.cuda.synchronize()
        same = torch.equal(a, b) and torch.equal(out, eager)
        lines.append(f"gemm bit identity ({m},{k})x({k},{n}) "
                     f"[{_gemm_plan_text(gemm.gemm_plan(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count))}]: "
                     f"two calls and a replay over rewritten inputs {'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise SystemExit(lines[-1])
    return lines


def _grad_err(got, want, tol: float) -> tuple[float, bool]:
    """Max abs error of a gradient and whether it is within ``tol``
    relative and ``tol`` times the largest |want| (at least 1) absolute."""
    import torch

    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item() if want.numel() else 0.0
    ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
          and bool(torch.isclose(got.float(), want.float(), rtol=tol, atol=tol * scale).all()))
    return err, ok


def _autograd(fn, inputs, douts):
    """Outputs of ``fn`` on copies of ``inputs``, and the copies' gradients
    for the outputs' gradients ``douts`` (None: no gradient)."""
    import torch

    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, d) for o, d in zip(outs, douts) if d is not None]
    torch.autograd.backward([o for o, _ in pairs], [d for _, d in pairs])
    return outs, [t.grad for t in ins]


def phase_backward_vs_plain() -> dict[str, float]:
    """Each backward kernel, through the ``ops`` operators' autograd formulas
    (forward kernel, then backward kernel), against autograd through the plain
    version on the same inputs and output gradients: flash attention at the
    training paths' shapes (orloj_gpt, GLM-4's GQA 16:1 at S 1024, Hymba's
    window, Arctic's group of 7) and at head sizes 16, 64, 128 and 192, with
    lengths, an empty row, a softcap, full attention, S 1 and bf16; RMSNorm at
    GLM-4's, Arctic's and Hymba's widths, ragged d, bf16; the gates at Arctic's
    (2048,128) k 2 and the reduced Arctic's 16 experts, E 3 to 256, k == E,
    ties, -inf logits, bf16.  Returns the error at each backward's main shape."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rms

    gen = torch.Generator(device="cuda").manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    errs: dict[str, float] = {}
    failures = []
    flash_cases = [
        # name, b, h, kv, s, hd, dtype, lengths, window, softcap, causal
        ("orloj_gpt train (8,12,256,64) f32", 8, 12, 12, 256, 64, f32, None, 0, 0.0, True),
        ("glm4 train GQA 16:1 (2,32->2,1024,128) f32", 2, 32, 2, 1024, 128, f32, None, 0, 0.0, True),
        ("arctic GQA 7:1 (2,56->8,256,128) f32", 2, 56, 8, 256, 128, f32, None, 0, 0.0, True),
        ("hymba reduced window 64 (2,4->2,96,64) f32", 2, 4, 2, 96, 64, f32, None, 64, 0.0, True),
        ("hymba window 1024 (1,25->5,1100,64) f32", 1, 25, 5, 1100, 64, f32, None, 1024, 0.0, True),
        ("hd 16 lengths [24,9,1,0] (4,4,24,16) f32", 4, 4, 4, 24, 16, f32, [24, 9, 1, 0], 0, 0.0, True),
        ("hd 32 full attention lengths [64,10] (2,4,64,32) f32", 2, 4, 4, 64, 32, f32, [64, 10], 0, 0.0,
         False),
        ("hd 192 ragged S=300 lengths [300,0] (2,8->2,300,192) f32", 2, 8, 2, 300, 192, f32, [300, 0], 0,
         0.0, True),
        ("softcap 2 lengths [256,100] (2,8->2,256,64) f32", 2, 8, 2, 256, 64, f32, [256, 100], 0, 2.0, True),
        ("softcap 2 hd 128 window 96 (2,14->2,256,128) f32", 2, 14, 2, 256, 128, f32, None, 96, 2.0, True),
        ("S=1 (3,4->2,1,64) f32", 3, 4, 2, 1, 64, f32, None, 0, 0.0, True),
        ("bf16 (8,12,256,64)", 8, 12, 12, 256, 64, bf16, None, 0, 0.0, True),
        ("bf16 hd 128 GQA 7:1 lengths [256,131] window 96", 2, 14, 2, 256, 128, bf16, [256, 131], 96, 0.0,
         True),
        ("bf16 hd 192 (2,8->2,256,192)", 2, 8, 2, 256, 192, bf16, None, 0, 0.0, True),
        ("GQA 16:1 S=1000 lengths [1000,0] (2,32->2,1000,128) f32", 2, 32, 2, 1000, 128, f32, [1000, 0], 0,
         0.0, True),
        ("hd 192 GQA 4:1 window 96 (2,8->2,256,192) f32", 2, 8, 2, 256, 192, f32, None, 96, 0.0, True),
        ("bf16 GQA 16:1 (2,32->2,512,128)", 2, 32, 2, 512, 128, bf16, None, 0, 0.0, True),
    ]
    for name, b, h, kv, s, hd, dt, lens, window, cap, causal in flash_cases:
        q = _randn(gen, (b, h, s, hd), dt)
        k, v = (_randn(gen, (b, kv, s, hd), dt) for _ in range(2))
        dout = _randn(gen, (b, h, s, hd), dt)
        lt = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        kw = dict(causal=causal, window=window, softcap=cap)
        before = fa.backward_launches
        (_,), got = _autograd(lambda *t: ops.flash_attention(*t, lt, **kw), (q, k, v), (dout,))
        launched = fa.backward_launches - before
        (_,), want = _autograd(lambda *t: ref.flash_attention_ref(*t, lengths=lt, **kw), (q, k, v), (dout,))
        torch.cuda.synchronize()
        tol = BF16_TOL if dt == bf16 else F32_TOL
        res = [_grad_err(a, w, tol) for a, w in zip(got, want)]
        err = max(e for e, _ in res)
        ok = all(o for _, o in res) and launched == 1 and all(a.dtype == dt for a in got)
        if lens is not None and 0 in lens:  # a row with no valid key: zero gradients, not NaN
            ok = ok and bool((got[0][lens.index(0)] == 0).all())
        log(f"backward vs plain: flash_attention_bwd {name}: dq/dk/dv max_abs_err "
            f"{', '.join(f'{e:.3e}' for e, _ in res)} (tol {tol} of the largest) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention_bwd {name}")
        if name.startswith("orloj_gpt train"):
            errs["flash_attention_bwd"] = err
        if name.startswith("glm4 train"):
            errs["glm4_flash_attention_bwd"] = err
        if name.startswith("arctic GQA"):
            errs["arctic_flash_attention_bwd"] = err
        if name == "bf16 (8,12,256,64)":
            errs["bf16_flash_attention_bwd"] = err

    rms_cases = [
        ("glm4 train (2048,4096) f32", 2048, 4096, f32),
        ("arctic (2048,7168) f32", 2048, 7168, f32),
        ("hymba (2048,1600) f32", 2048, 1600, f32),
        ("hymba reduced (192,256) f32", 192, 256, f32),
        ("ragged (33,130) f32", 33, 130, f32),
        ("T=1 (1,4096) f32", 1, 4096, f32),
        ("bf16 (2048,4096)", 2048, 4096, bf16),
        ("bf16 ragged (33,130)", 33, 130, bf16),
        (f"widest (4,{rms.MAX_BACKWARD_D}) f32 (rereads)", 4, rms.MAX_BACKWARD_D, f32),
    ]
    for name, t, d, dt in rms_cases:
        x = _randn(gen, (t, d), dt) * 3
        scale = _randn(gen, (d,), f32)
        dy = _randn(gen, (t, d), dt)
        before = rms.backward_launches
        _, (dx, ds) = _autograd(lambda a, w: ops.rmsnorm(a, w, eps=1e-5), (x, scale), (dy,))
        launched = rms.backward_launches - before
        _, (wdx, wds) = _autograd(lambda a, w: ref.rmsnorm_ref(a, w, 1e-5), (x, scale), (dy,))
        torch.cuda.synchronize()
        ex, okx = _grad_err(dx, wdx, BF16_TOL if dt == bf16 else ROW_TOL)
        es, oks = _grad_err(ds, wds, BF16_TOL if dt == bf16 else F32_TOL)
        ok = okx and oks and launched == 1 and dx.dtype == dt and ds.dtype == f32
        log(f"backward vs plain: rmsnorm_bwd {name}: dx max_abs_err {ex:.3e} (tol "
            f"{BF16_TOL if dt == bf16 else ROW_TOL}), dscale {es:.3e} (tol {BF16_TOL if dt == bf16 else F32_TOL}) "
            f"of the largest {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"rmsnorm_bwd {name}")
        if name.startswith("glm4 train"):
            errs["rmsnorm_bwd"] = max(ex, es)

    tie = torch.zeros((6, 16), device="cuda")
    tie[1] = 3.0
    tie[2, [3, 9, 12]] = 5.0
    tie[4] = torch.arange(16, device="cuda") % 4
    neg_inf = _randn(gen, (4, 16), f32)
    neg_inf[0, 1:] = -math.inf
    neg_inf[1, ::2] = -math.inf
    gating_cases = [
        ("arctic (2048,128) k 2", _randn(gen, (2048, 128), f32) * 2, 2),
        ("arctic reduced 16 experts (192,16) k 2", _randn(gen, (192, 16), f32) * 2, 2),
        ("E=3 (64,3) k 2", _randn(gen, (64, 3), f32) * 2, 2),
        ("E=130 (64,130) k 4", _randn(gen, (64, 130), f32) * 2, 4),
        ("E=256 (2048,256) k 2", _randn(gen, (2048, 256), f32) * 2, 2),
        ("k == E (64,8) k 8", _randn(gen, (64, 8), f32) * 2, 8),
        ("ties (6,16) k 4", tie, 4),
        ("-inf logits (4,16) k 4", neg_inf, 4),
        ("bf16 (512,128) k 2", _randn(gen, (512, 128), bf16) * 2, 2),
    ]
    for name, logits, k in gating_cases:
        dg = _randn(gen, (logits.shape[0], k), f32)
        before = gating.backward_launches
        (_, ids), (got,) = _autograd(lambda x: ops.moe_gating(x, k), (logits,), (dg, None))
        launched = gating.backward_launches - before
        (_, wids), (want,) = _autograd(lambda x: ref.moe_gating_ref(x, k), (logits,), (dg, None))
        torch.cuda.synchronize()
        tol = BF16_TOL if logits.dtype == bf16 else ROW_TOL
        err, ok = _grad_err(got, want, tol)
        ok = ok and launched == 1 and torch.equal(ids, wids) and got.dtype == logits.dtype
        log(f"backward vs plain: moe_gating_bwd {name}: dlogits max_abs_err {err:.3e} (tol {tol} of the "
            f"largest), ids equal {torch.equal(ids, wids)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"moe_gating_bwd {name}")
        if name.startswith("arctic (2048"):
            errs["moe_gating_bwd"] = err
    failures += _bit_identity(gen)
    if failures:
        raise SystemExit(f"backward kernels disagree with autograd through their plain versions: {failures}")
    return errs


def _bit_identity(gen) -> list[str]:
    """Each redesigned backward called twice on the same inputs: flash at
    GLM-4-9B's (2,32->2,1024,128) f32 (split partials), RMSNorm at
    (2048,4096) f32 and the gates at Arctic's (2048,128) k 2; the gradients
    must be equal bit for bit (no atomics)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import rmsnorm as rms

    q, dout = (_randn(gen, (2, 32, 1024, 128), torch.float32) for _ in range(2))
    k, v = (_randn(gen, (2, 2, 1024, 128), torch.float32) for _ in range(2))
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    x, dy = (_randn(gen, (2048, 4096), torch.float32) for _ in range(2))
    scale = _randn(gen, (4096,), torch.float32)
    logits = _randn(gen, (2048, 128), torch.float32) * 2
    _, ids = gating.moe_gating_cuda(logits, 2)
    dg = _randn(gen, (2048, 2), torch.float32)
    calls = {
        "flash_attention_bwd (2,32->2,1024,128) f32": lambda: fa.flash_attention_backward_cuda(q, k, v, out,
                                                                                               dout, lse),
        "rmsnorm_bwd (2048,4096) f32": lambda: rms.rmsnorm_backward_cuda(x, scale, dy, eps=1e-5),
        "moe_gating_bwd (2048,128) k 2 f32": lambda: (gating.moe_gating_backward_cuda(logits, ids, dg),),
    }
    failures = []
    for name, call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        log(f"backward vs plain: {name}: two calls bit-identical {same} {'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"{name} bit identity")
    return failures


def _plan_text(plan) -> str:
    """A flash plan in one phrase."""
    unit = ("warpgroup" if plan.route == "wgmma" else "warp") + ("s" if plan.warps > 1 else "")
    return (f"plan {plan.route}, {plan.warps} {unit}, {plan.heads}x{plan.positions} rows, {plan.block_k}-key "
            f"tiles, {plan.stages} stages, {plan.shared_bytes} B")


def _flash_bit_identity(gen) -> list[str]:
    """The flash forward on each route called twice on the same inputs, then
    captured in a CUDA graph, its input buffers rewritten with new values
    and the graph replayed: the two calls must be equal bit for bit (no
    atomics), and the replay equal to an eager call on the new values (the
    tensor maps the capture encoded point at the same buffers)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    failures = []
    for name, b, h, kv, s, hd, dt, lse in (("glm4 (2,32->2,1024,128) f32 with LSE", 2, 32, 2, 1024, 128,
                                            torch.float32, True),
                                           ("main path (8,12,256,64) f32", 8, 12, 12, 256, 64, torch.float32,
                                            False),
                                           ("musicgen (8,32,256,64) bf16", 8, 32, 32, 256, 64, torch.bfloat16,
                                            False),
                                           ("nemotron (8,96->8,256,192) f32", 8, 96, 8, 256, 192, torch.float32,
                                            False),
                                           ("smallest bucket (8,12,32,64) f32", 8, 12, 12, 32, 64, torch.float32,
                                            False)):
        q = _randn(gen, (b, h, s, hd), dt)
        k, v = (_randn(gen, (b, kv, s, hd), dt) for _ in range(2))

        def call():
            res = fa.flash_attention_cuda(q, k, v, return_lse=lse)
            return res if lse else (res,)

        first, second = call(), call()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            call()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = call()
        for t in (q, k, v):
            t.copy_(_randn(gen, t.shape, dt))
        graph.replay()
        eager = call()
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(first, second))
        replay_same = all(torch.equal(a, c) for a, c in zip(replayed, eager))
        ok = same and replay_same
        plan = fa.flash_plan(b, h, kv, s, hd, dt, 0, sms)
        log(f"kernel vs plain: flash_attention {name}: two calls bit-identical {same}, a graph replay over "
            f"rewritten inputs bit-identical to an eager call {replay_same} {'ok' if ok else 'FAIL'}; "
            f"{_plan_text(plan)}")
        if not ok:
            failures.append(f"flash_attention {name} bit identity")
    return failures


def _decode_bit_identity(gen) -> list[str]:
    """The decode kernel on each route called twice on the same inputs and
    once as a CUDA graph's replay: GLM-4-9B's g 16 over a bf16 cache at
    4,096 slots and Granite's g 48 in float32 (tensor cores), xLSTM's head
    size 512 (wide route), orloj_gpt's step (SIMT); the three outputs must
    be equal bit for bit (no atomics, merges in a fixed order)."""
    import torch

    from repro_torch.kernels import decode_attention as dec

    failures = []
    for name, b, h, kv, s, hd, cdt in (("glm4 f32 q, bf16 cache (8,32->2,4096,128)", 8, 32, 2, 4096, 128, torch.bfloat16),
                                       ("granite f32 (4,48->1,4096,128)", 4, 48, 1, 4096, 128, torch.float32),
                                       ("xlstm hd 512 f32 (8,4->4,256,512)", 8, 4, 4, 256, 512, torch.float32),
                                       ("main path f32 (8,12,256,64)", 8, 12, 12, 256, 64, torch.float32)):
        q = _randn(gen, (b, h, hd), torch.float32)
        kc, vc = (_randn(gen, (b, kv, s, hd), cdt) for _ in range(2))
        vl = torch.randint(0, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
        first, second = (dec.decode_attention_cuda(q, kc, vc, vl) for _ in range(2))
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            dec.decode_attention_cuda(q, kc, vc, vl)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = dec.decode_attention_cuda(q, kc, vc, vl)
        graph.replay()
        torch.cuda.synchronize()
        same = torch.equal(first, second) and torch.equal(first, replayed)
        log(f"kernel vs plain: decode_attention {name}: two calls and a graph replay bit-identical {same} "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"decode_attention {name} bit identity")
    return failures


def phase_serve(engine, ecfg, label: str, must_launch: tuple[str, ...]) -> dict[str, int]:
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import length_sampler, make_scheduler

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lm = engine.profile_latency_model()
    log(f"{label}: Eq.3 fit on the card: c0={lm.c0:.4f} ms, c1={lm.c1 * 1e3:.5f} ms/ktok "
        f"({time.perf_counter() - t0:.1f} s to profile {len(ecfg.buckets) * len(ecfg.batch_sizes)} shapes)")
    reqs, hist = engine.make_requests(
        N_REQUESTS, lm, length_sampler=length_sampler, slo_scale=3.0, utilization=0.7, seed=0
    )
    engine.executor.drain_measured()
    res = engine.serve(reqs, make_scheduler("orloj", lm, hist, ecfg.batch_sizes))
    counts = ops.launch_counts()
    log(f"{label}: orloj {res.summary()} n_total={res.n_total} conserved={res.conserved} "
        f"batches={res.n_batches} launches={counts}")
    # How well Eq. 3 predicts the batches it was used to plan.
    err = sorted(abs(ms - lm.batch_time([float(b)] * k)) / ms for k, b, ms in engine.executor.drain_measured())
    if err:
        log(f"{label}: Eq.3 relative error over the {len(err)} served batches: median "
            f"{err[len(err) // 2]:.4f}, max {err[-1]:.4f}")
    if res.n_total != N_REQUESTS or not res.conserved:
        raise SystemExit(f"{label}: {res.n_total} of {N_REQUESTS} requests accounted, conserved={res.conserved}")
    for name in must_launch:
        if counts[name] <= 0:
            raise SystemExit(f"{label}: the prefill path launched no {name} kernel")
    return counts


@contextlib.contextmanager
def _routing_log():
    """Records (router logits, gates, ids) of every MoE layer in a forward."""
    from repro_torch.kernels import ops

    seen: list = []
    gating = ops.moe_gating

    def recording(logits, top_k):
        gates, ids = gating(logits, top_k)
        seen.append((logits, gates, ids))
        return gates, ids

    ops.moe_gating = recording
    try:
        yield seen
    finally:
        ops.moe_gating = gating


# Errors of the kernels' calls on the decode ≡ forward paths, each held
# against its plain version on the call's own inputs: name -> (calls, max_abs_err).
PATH_HELD: dict[str, tuple[int, float]] = {}


def _plain(name: str, args, kw):
    """The plain version of a kernel call made through ``ops``."""
    from repro_torch.kernels import ref

    if name == "flash_attention":
        q, k, v, *rest = args
        lengths = rest[0] if rest else kw.pop("lengths", None)
        return ref.flash_attention_ref(q, k, v, lengths=lengths, **kw)
    if name == "decode_attention":
        return ref.decode_attention_ref(*args, **kw)
    if name == "rmsnorm":
        x, scale = args
        return ref.rmsnorm_ref(x.reshape(-1, x.shape[-1]), scale, kw.get("eps", 1e-6)).reshape(x.shape)
    if name == "selective_scan":
        y, h = ref.selective_scan_ref(*args)
        return y, (h if kw.get("last_state") else None)
    return ref.moe_gating_ref(*args, **kw)


@contextlib.contextmanager
def _kernel_log():
    """Holds every call of the five forward kernels through ``repro_torch.kernels.ops``
    against its plain version on the same inputs as the call returns (a
    decode cache is written before the call and again only by the next
    step), and records (name, shapes, types, max_abs_err, ok, and for bf16
    attention both errors against the plain version in float32) for
    :func:`_hold_path_calls`: attention as :func:`_attention_ok`; RMSNorm
    to ROW_TOL relative and absolute; the gating's ids exactly and its
    gates to ROW_TOL; the selective scan's y and last state to F32_TOL.  Only the wrappers' routes are
    wrapped: the launches and their counts are the path's own; the plain
    versions launch none of the kernels.  A call inside a CUDA graph's
    capture runs nothing and is not held; the graph's replays make no call
    (:func:`_hold_decode_steps` holds the decode graph's)."""
    import torch

    from repro_torch.kernels import ops

    seen: list = []
    wrapped = {name: getattr(ops, name) for name in ("flash_attention", "decode_attention",
                                                      "rmsnorm", "moe_gating", "selective_scan")}

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if args[0].is_cuda and torch.cuda.is_current_stream_capturing():
                return out  # recorded into a graph: nothing ran, nothing to hold
            want = _plain(name, args, dict(kw))
            shape = ",".join(str(tuple(a.shape)) for a in args if isinstance(a, torch.Tensor) and a.dim() > 1)
            dtypes = "/".join(sorted({str(a.dtype)[6:] for a in args if isinstance(a, torch.Tensor)
                                      and a.is_floating_point()}))
            vs_f32 = None
            if name == "moe_gating":
                err = (out[0] - want[0]).abs().max().item()
                ok = torch.equal(out[1], want[1]) and err <= ROW_TOL
            elif name == "rmsnorm":
                err = (out.float() - want.float()).abs().max().item()
                ok = bool(torch.isclose(out.float(), want.float(), rtol=ROW_TOL, atol=ROW_TOL).all())
            elif name == "selective_scan":
                pairs = [(a, b) for a, b in zip(out, want) if b is not None]
                err = max((a - b).abs().max().item() for a, b in pairs)
                ok = all(torch.allclose(a, b, rtol=F32_TOL, atol=F32_TOL) for a, b in pairs)
            else:
                err, ok = _attention_ok(out, want)
                if "bfloat16" in dtypes:  # both against the plain version in float32 on the same values
                    exact = _plain(name, [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point()
                                          else a for a in args], dict(kw))
                    vs_f32 = ((out.float() - exact).abs().max().item(),
                              (want.float() - exact).abs().max().item())
            seen.append((name, shape, dtypes, err, ok, vs_f32))
            return out
        return call

    for name, fn in wrapped.items():
        setattr(ops, name, recorder(name, fn))
    try:
        yield seen
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)


def _hold_path_calls(calls, label: str) -> None:
    """The recorded kernel calls' errors, one line per kernel and shape;
    fails if any call disagreed with its plain version."""
    groups: dict[tuple, list] = {}
    failures = []
    for name, shape, dtypes, err, ok, vs_f32 in calls:
        groups.setdefault((name, shape, dtypes), []).append((err, vs_f32))
        if not ok:
            failures.append(f"{name} {shape} {dtypes}")
    for (name, shape, dtypes), rows in groups.items():
        errs = [e for e, _ in rows]
        n, worst = PATH_HELD.get(name, (0, 0.0))
        PATH_HELD[name] = (n + len(errs), max(worst, max(errs)))
        f32 = [v for _, v in rows if v is not None]
        extra = (f"; against the plain version in float32 on the same values: kernel "
                 f"{max(k for k, _ in f32):.3e}, bf16 plain version {max(p for _, p in f32):.3e}") if f32 else ""
        log(f"{label} kernels vs plain on the path's own inputs: {name} {shape} {dtypes}: {len(errs)} calls, "
            f"max_abs_err {max(errs):.3e}{extra}")
    if failures:
        raise SystemExit(f"{label}: kernel calls of the path disagree with their plain versions: "
                         f"{sorted(set(failures))}")


def phase_card_vs_cpu(model, params, label: str) -> None:
    """What comes out is right: finite logits of the expected shape that
    agree with the same weights run through the plain path on the CPU, and,
    for an MoE model, the same expert ids in both runs."""
    import numpy as np
    import torch

    from repro_torch.models import Model

    cfg = model.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(1, 1000, size=(2, 32)))}
    if cfg.frontend == "vision":  # a full image prefix before the tokens
        batch["frontend_embeds"] = torch.from_numpy(
            rng.normal(size=(2, cfg.n_frontend_tokens, 1024)).astype(np.float32))
    seq = 32 + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    with torch.no_grad(), _routing_log() as card_routes:
        got = model.logits(params, {k: v.to(model.device) for k, v in batch.items()})
    with torch.no_grad(), _routing_log() as cpu_routes:
        want = Model(cfg, device="cpu").logits(_to_cpu(params), batch)
    err = (got.cpu() - want).abs().max().item()
    ok = got.shape == (2, seq, cfg.vocab_size) and bool(torch.isfinite(got).all())
    log(f"{label}: logits {tuple(got.shape)} finite={ok}, max |logit| {want.abs().max().item():.3f}; "
        f"card vs CPU max_abs_err {err:.3e} (tol {LOGITS_TOL})")
    if not ok or not err <= LOGITS_TOL:
        raise SystemExit(f"{label}: the model's logits on the card disagree with the CPU's")
    if cfg.is_moe:
        if len(card_routes) != cfg.n_layers or len(cpu_routes) != cfg.n_layers:
            raise SystemExit(f"{label}: {len(card_routes)} and {len(cpu_routes)} routings for {cfg.n_layers} layers")
        for (card_logits, _, card_ids), (cpu_logits, _, cpu_ids) in zip(card_routes, cpu_routes):
            probs = torch.softmax(cpu_logits.double(), dim=-1).sort(dim=-1, descending=True).values
            gap = (probs[:, cfg.top_k - 1] - probs[:, cfg.top_k]).min().item()
            same = torch.equal(card_ids.cpu(), cpu_ids)
            log(f"{label}: routing ids of {tuple(cpu_ids.shape)} equal on card and CPU: {same}; smallest gap "
                f"between a row's k-th and (k+1)-th probability (k = {cfg.top_k}) {gap:.3e}")
            if not same:
                raise SystemExit(f"{label}: the card routed tokens to other experts than the CPU")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def phase_tokens(engine, label: str, *, hold: bool = False) -> dict[str, int]:
    """Token requests through continuous batching on the decode kernel;
    with ``hold``, every decode call of the path is held against its plain
    version on its own inputs as it returns."""
    from repro_torch.core.tokensched import LengthAwareTokenScheduler, TokenSchedConfig
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    with _kernel_log() if hold else contextlib.nullcontext([]) as calls:
        dec = engine.decode_executor(max_batch=8, max_cache=256)
        if hold:
            _hold_decode_steps(dec, calls)
        reqs = engine.make_token_requests(N_TOKEN_REQUESTS, dec, seed=0)
        step_ms = dec.calibrate()
        # Scheduler SLOs far above the requests' own: this phase checks that
        # every token is served; the requests' SLOs still decide the finish rate.
        cfg = TokenSchedConfig(max_batch=8, ttft_slo_ms=1e9, tpot_slo_ms=1e9, d0=step_ms, d1=0.0)
        res = engine.serve_tokens(reqs, LengthAwareTokenScheduler(cfg), dec)
    counts = ops.launch_counts()
    done = sum(r.tokens_done for r in reqs)
    want = sum(r.out_tokens for r in reqs)
    log(f"{label} tokens: token_orloj {res.summary()} tokens {done}/{want} step {step_ms:.4f} ms "
        f"(full batch 8, cache 256) launches={counts}")
    if res.n_total != N_TOKEN_REQUESTS or not res.conserved:
        raise SystemExit(f"{label} tokens: requests not conserved")
    if any(r.tokens_done != r.out_tokens for r in reqs):
        raise SystemExit(f"{label} tokens: {done} of {want} tokens served")
    if counts["decode_attention"] <= 0:
        raise SystemExit(f"{label} tokens: the decode path launched no decode_attention kernel")
    if hold:
        _hold_path_calls([c for c in calls if c[0] == "decode_attention"], f"{label} tokens")
    return counts


def _hold_decode_steps(dec, calls: list) -> None:
    """Hold each step of the decode executor ``dec`` (a replay of its graph,
    which makes no call through ``ops``) against the plain version on the
    step's own inputs, the static tensors the graph read, after the timed
    region; recorded as :func:`_kernel_log` records."""
    from repro_torch.kernels import ref

    once = dec._decode_once

    def held() -> float:
        ms = once()
        want = ref.decode_attention_ref(dec._q, dec._kc, dec._vc, dec._valid)
        err, ok = _attention_ok(dec.last_out, want)
        shape = ",".join(str(tuple(t.shape)) for t in (dec._q, dec._kc, dec._vc))
        calls.append(("decode_attention", shape, "float32", err, ok, None))
        return ms

    dec._decode_once = held


def phase_graphs(engine, label: str, shapes) -> None:
    """Each served shape is one captured CUDA graph: at each of ``shapes``
    (warmed by the profile), the replayed logits against an eager
    ``model.logits`` call on the same tokens, which must be equal bit for
    bit (the same kernels on the same inputs); then the eager forward's ms
    and the replay's (host clock, median of 5, between synchronises) and
    one call of each under the profiler (busy ms, idle share)."""
    import numpy as np
    import torch

    ex, model = engine.executor, engine.model
    rng = np.random.default_rng(8)
    for shape in shapes:
        tokens = rng.integers(1, min(1000, model.cfg.vocab_size), size=shape).astype(np.int32)
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)).cuda()}
        ex._run(tokens)
        got = ex.last_logits.clone()

        def eager():
            with torch.no_grad():
                return model.logits(engine.params, batch)

        want = eager()
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"{label} graphs {shape}: replayed logits {tuple(got.shape)} equal to eager ones bit for bit: "
            f"{same}; max |Δ| {err:.3e} of max |logit| {scale:.3f} ({err / scale:.3e}) {'ok' if same else 'FAIL'}")
        if not same:
            raise SystemExit(f"{label} graphs {shape}: the replayed logits differ from the eager forward's")
        eager_ms, replay_ms = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager()
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
            replay_ms.append(ex._run(tokens)[0])
        log(f"{label} graphs {shape}: eager forward {sorted(eager_ms)[2]:.4f} ms, replay "
            f"{sorted(replay_ms)[2]:.4f} ms (host clock, median of 5; the replay as the executor measures it)")
        for name, fn in ((f"eager forward {shape}", eager), (f"replay {shape}", lambda: ex._run(tokens))):
            _profile(fn, f"{label} graphs", name)


def phase_where_time_goes(engine, label: str) -> None:
    """Device time by kernel over one prefill batch at (8, 256) and one
    full-capacity decode step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    tokens = np.ones((8, 256), np.int32)
    engine.executor._run(tokens)  # warm
    dec = engine.decode_executor(max_batch=8, max_cache=256)
    dec._valid = torch.full_like(dec._valid, 256)
    for name, fn in (("prefill (8,256)", lambda: engine.executor._run(tokens)),
                     ("decode step (8 rows, cache 256)", dec._decode_once)):
        _profile(fn, label, name)


def _profile(fn, label: str, name: str) -> list:
    """Wall time, device busy time, idle share and the top operations by
    device time of one call of ``fn``, from torch.profiler; returns the
    device operations (``key_averages`` rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    rows = [(e.key, e.device_time_total / 1e3) for e in events]
    busy = sum(t for _, t in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    share = ", ".join(f"{k[:48]} {t:.4f} ms" for k, t in top)
    if busy == 0:
        log(f"{label} where the time goes: {name}: the profiler recorded no device time; "
            f"wall {wall_ms:.4f} ms")
    else:
        log(f"{label} where the time goes: {name}: wall {wall_ms:.4f} ms, device busy {busy:.4f} ms "
            f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}) in {sum(e.count for e in events)} device "
            f"operations; top: {share}")
    gating = [e for e in events if "moe_gating_kernel" in e.key]
    if gating:
        log(f"{label} where the time goes: {name}: moe_gating kernel's own device time "
            f"{sum(e.device_time_total for e in gating) / 1e3:.6f} ms over "
            f"{sum(e.count for e in gating)} launches")
    return events


def _step_inputs(cfg, rng, rows: int, steps: int, device):
    """What ``decode_step`` takes for ``steps`` positions of ``rows`` rows:
    token ids, or an audio model's (rows, steps, 512) frame embeddings."""
    import numpy as np
    import torch

    if cfg.frontend == "audio":
        return torch.from_numpy(rng.normal(size=(rows, steps, 512)).astype(np.float32)).to(device)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(rows, steps))).to(device)


def _forward_batch(cfg, inputs) -> dict:
    """The forward's batch over the same positions: audio reads the frames; a
    vision model takes an empty image prefix (a decode step reads tokens)."""
    import torch

    if cfg.frontend == "audio":
        return {"frontend_embeds": inputs}
    if cfg.frontend == "vision":
        return {"frontend_embeds": torch.zeros((inputs.shape[0], 0, 1024), device=inputs.device),
                "tokens": inputs}
    return {"tokens": inputs}


def phase_decode_matches_forward(model, params, label: str, *, prompt: int = PROMPT, rows: int = 2,
                                 must_launch=("decode_attention", "flash_attention")) -> dict[str, int]:
    """Decode ≡ forward on the card: ``prompt`` positions of ``rows`` rows
    through ``Model.logits``, and the same inputs one at a time through
    ``decode_step`` over a cache of the type the stack computes in (the
    logits': float32, or bfloat16 for MusicGen's frames), held to
    LOGITS_TOL, or in bfloat16 to BF16_MODEL_TOL times the largest logit
    (at least 1).  An MoE forward
    routes rows·prompt tokens against a capacity C, a step ``rows`` against
    its own: the forward's dropped assignments are printed, and a row is
    held only before its first dropped one (attention carries a drop to
    every later position)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.models.moe import capacity

    cfg = model.cfg
    inputs = _step_inputs(cfg, np.random.default_rng(1), rows, prompt, model.device)
    ops.reset_launch_counts()
    with torch.no_grad(), _kernel_log() as calls, _routing_log() as routes:
        full = model.logits(params, _forward_batch(cfg, inputs))
        n_forward = len(routes)
        # The cache takes the type the stack computes in: the logits'.
        bf16 = full.dtype == torch.bfloat16
        cache_dtype = full.dtype
        cache = model.init_cache(rows, prompt, dtype=cache_dtype)
        steps = [model.decode_step(params, inputs[:, i : i + 1], cache, i)[0][:, 0]
                 for i in range(prompt)]
        dec = torch.stack(steps, 1)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    held = torch.ones((rows, prompt), dtype=torch.bool)
    dropped = 0
    for _, _, ids in routes[:n_forward]:
        flat = ids.reshape(-1).long().cpu()
        onehot = F.one_hot(flat, cfg.n_experts)
        pos_in_e = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
        drop = pos_in_e >= capacity(rows * prompt, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        dropped += int(drop.sum())
        held &= drop.reshape(rows, prompt, cfg.top_k).any(-1).cumsum(1) == 0
    if not held.any():
        raise SystemExit(f"{label} decode ≡ forward: every position follows a dropped assignment")
    err = (dec.float() - full.float()).abs()[held.to(dec.device)].max().item()
    top = full.float().abs().max().item()
    tol = BF16_MODEL_TOL * max(1.0, top) if bf16 else LOGITS_TOL
    ok = dec.shape == full.shape and bool(torch.isfinite(dec).all()) and err <= tol
    moe = (f"; the forward dropped {dropped} of {rows * prompt * cfg.top_k * n_forward} assignments, "
           f"{int(held.sum())} of {held.numel()} positions held") if cfg.is_moe else ""
    log(f"{label} decode ≡ forward: {prompt} positions × {rows} rows, {cfg.n_layers} layers, "
        f"{str(cache_dtype)[6:]} compute and cache ({_cache_slots(cache)} slots): "
        f"max |logit| {top:.3f}, max_abs_err {err:.3e} (tol {tol:.3e}){moe}; launches={counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: token-by-token decoding disagrees with the forward")
    for name in must_launch:
        if counts[name] <= 0:
            raise SystemExit(f"{label} decode ≡ forward: no {name} kernel was launched")
    if not must_launch and any(counts.values()):
        raise SystemExit(f"{label} decode ≡ forward: a kernel was launched on a path that has none: {counts}")
    _hold_path_calls(calls, f"{label} decode ≡ forward")
    return counts


def _cache_slots(cache) -> str:
    """The KV slots of the first attention layer's cache, or "no KV"."""
    kv = next((c["kv"]["k"].shape[2] for c in cache if "kv" in c), None)
    return "no KV" if kv is None else str(kv)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


# The timed decode steps: (rows, cache slots, cache type).  At B 1 and 8
# over a full float32 cache of 256 slots, and at B 8 over the models'
# default bf16 cache at decode_32k's 32,768 slots.
DECODE_STEPS = ((1, 256, "float32"), (8, 256, "float32"), (8, 32768, "bfloat16"))


def phase_decode_step_time(model, params, label: str) -> None:
    """The decode step at each of DECODE_STEPS with every cache slot valid:
    its time as a caller sees it (host clock to a synchronise) and the
    host's share of it (the enqueue), the same step replayed as a CUDA graph
    (the device's time alone), its launches and a profile, beside two
    bounds: every parameter byte read once at the HBM rate, and the bytes a
    step must move (every weight but the embedding table, of which it
    gathers B rows; the cache; the logits written)."""
    import torch

    from repro_torch.kernels import ops

    cfg = model.cfg
    param_bytes = _nbytes(params)
    weight_ms = param_bytes / HBM_BYTES_PER_S * 1e3
    table = params["embed"]["table"]
    for b, slots, dtype_name in DECODE_STEPS:
        cache = model.init_cache(b, slots, dtype=getattr(torch, dtype_name))
        tokens = torch.ones((b, 1), dtype=torch.long, device=model.device)
        step_bytes = (param_bytes - (0 if cfg.tie_embeddings else _nbytes(table))
                      + b * cfg.d_model * 4 + _nbytes(cache) + b * cfg.vocab_size * 4)
        step_ms_bound = step_bytes / HBM_BYTES_PER_S * 1e3

        def step():
            with torch.no_grad():
                model.decode_step(params, tokens, cache, slots - 1)  # every slot valid

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        times, enqueue = [], []
        for _ in range(15):
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            enqueue.append((t1 - t0) * 1e3)
        times.sort()
        enqueue.sort()
        med = times[len(times) // 2]
        device_ms = time_ms(step, reps=3, graphs=3)  # the same step replayed as a CUDA graph
        ops.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        log(f"{label} decode step B {b}, cache {slots} {dtype_name}: median {med:.4f} ms (min {times[0]:.4f}, "
            f"max {times[-1]:.4f}, 15 steps), of which the host's enqueue median "
            f"{enqueue[len(enqueue) // 2]:.4f} ms; as a CUDA graph {device_ms:.4f} ms; weight-read bound "
            f"{weight_ms:.4f} ms ({param_bytes} parameter bytes / 3.35 TB/s), ratio {med / weight_ms:.3f} "
            f"(graph {device_ms / weight_ms:.3f}); step byte bound {step_ms_bound:.4f} ms ({step_bytes} "
            f"bytes), ratio {med / step_ms_bound:.3f} (graph {device_ms / step_ms_bound:.3f}); "
            f"launches per step {counts}")
        _profile(step, label, f"decode step ({b} rows, cache {slots} {dtype_name})")
        del cache
        _release()


def phase_step_card_vs_cpu(cfg, label: str) -> None:
    """A few decode steps on the card against the same weights on the CPU,
    with a float32 and a bfloat16 cache (``pos`` a device tensor for the
    bf16 one): logits to LOGITS_TOL, the float32 cache to F32_TOL, the bf16
    cache to one bf16 step (rtol 2**-7)."""
    import numpy as np
    import torch

    from repro_torch.models import Model

    card = Model(cfg, device="cuda")
    params = card.init(torch.Generator(device="cuda").manual_seed(2))
    _check_no_grad(params, label)
    cpu, cpu_params = Model(cfg, device="cpu"), _to_cpu(params)
    log(f"{label}: {cfg.n_layers} layer at full width, vocab {cfg.vocab_size}: "
        f"{card.param_count(params)} params")
    rng = np.random.default_rng(2)
    for dtype in (torch.float32, torch.bfloat16):
        c_card, c_cpu = card.init_cache(2, 16, dtype=dtype), cpu.init_cache(2, 16, dtype=dtype)
        err = 0.0
        with torch.no_grad():
            for i in range(4):
                tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 1)))
                pos = torch.tensor(i, device="cuda") if dtype == torch.bfloat16 else i
                got, c_card = card.decode_step(params, tok.cuda(), c_card, pos)
                want, c_cpu = cpu.decode_step(cpu_params, tok, c_cpu, i)
                if got.shape != (2, 1, cfg.vocab_size) or not bool(torch.isfinite(got).all()):
                    raise SystemExit(f"{label}: step {i} gave logits {tuple(got.shape)}, not all finite")
                err = max(err, (got.cpu() - want).abs().max().item())
        rtol, atol = (2**-7, 1e-4) if dtype == torch.bfloat16 else (0.0, F32_TOL)
        pairs = [(a["kv"][n].cpu().float(), b["kv"][n].float())
                 for a, b in zip(c_card, c_cpu) for n in ("k", "v")]
        cache_err = max((a - b).abs().max().item() for a, b in pairs)
        cache_ok = all(torch.isclose(a, b, rtol=rtol, atol=atol).all() for a, b in pairs)
        ok = err <= LOGITS_TOL and cache_ok
        log(f"{label}: 4 decode steps, {str(dtype)[6:]} cache: logits card vs CPU max_abs_err {err:.3e} "
            f"(tol {LOGITS_TOL}); cache max_abs_err {cache_err:.3e} (rtol {rtol}, atol {atol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: the decode step on the card disagrees with the CPU's")


def _attention_entries(gen, b, h, kv, s, hd) -> tuple[dict, dict]:
    """Times and bounds of both attention kernels at one shape, float32; the
    decode kernel also over a bfloat16 cache (``bf16_cache_*``)."""
    import torch

    flash = _flash_entry(gen, b, h, kv, s, hd, torch.float32)
    flash["tc_roofline_share"] = flash["tc_bound_ms"] / flash["ms"]
    decode = _decode_entry(gen, b, h, kv, s, hd, torch.float32, torch.float32)
    over_bf16 = _decode_entry(gen, b, h, kv, s, hd, torch.float32, torch.bfloat16)
    for key in ("ms", "bound_ms", "bound_by"):
        decode[f"bf16_cache_{key}"] = over_bf16[key]
    return flash, decode


def _flash_entry(gen, b, h, kv, s, hd, dtype, window: int = 0, prefix: int = 0) -> dict:
    """Flash's time, plain and SDPA times and bounds at one causal shape,
    with a sliding window when ``window > 0`` and the keys below ``prefix``
    seen through it (the bounds count only the (query, key) pairs the
    masks keep; SDPA takes the same mask).
    ``bound_ms`` counts the operations at the peak rate of the inputs'
    type (float32: SIMT; bf16: the tensor cores), ``tc_bound_ms`` on the
    tensor cores."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    q = _randn(gen, (b, h, s, hd), dtype)
    k, v = (_randn(gen, (b, kv, s, hd), dtype) for _ in range(2))
    kr, vr = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
    mask = None
    if window > 0:
        i, j = torch.arange(s, device="cuda")[:, None], torch.arange(s, device="cuda")[None, :]
        mask = (j <= i) & ((j > i - window) | (j < prefix))
    tc_bound, tc_by = flash_tc_bound(q, k, None, True, window, prefix)
    plan = fa.flash_plan(b, h, kv, s, hd, dtype, window, torch.cuda.get_device_properties(0).multi_processor_count)
    # The peak rate of the inputs' type: float32 outside the tensor cores, bf16 on them.
    bound, by = (tc_bound, tc_by) if dtype == torch.bfloat16 else flash_bound(q, k, None, True, window, prefix)
    e = {
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, window=window, prefix=prefix)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, window=window, prefix=prefix)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask,
                                                                    is_causal=mask is None)),
        "tc_bound_ms": tc_bound, "tc_bound_by": tc_by, "window": window, "prefix": prefix,
        "plan": {"route": plan.route, "warps": plan.warps, "heads": plan.heads, "positions": plan.positions,
                 "block_k": plan.block_k, "stages": plan.stages, "shared_bytes": plan.shared_bytes},
    }
    log(f"flash ({b},{h}->{kv},{s},{hd}) {str(dtype)[6:]} window {window} prefix {prefix}, ratios in this call: "
        f"/SDPA {e['ms'] / e['library_ms']:.3f}, /plain {e['ms'] / e['plain_ms']:.3f}, "
        f"/tc_bound {e['ms'] / tc_bound:.3f} (tc_bound {tc_bound:.6f} ms, {tc_by}), "
        f"/bound {e['ms'] / bound:.3f} (bound {bound:.6f} ms, {by}); {e['ms']:.6f} ms; {_plan_text(plan)}")
    return e


def _decode_entry(gen, b, h, kv, s, hd, q_dtype, cache_dtype) -> dict:
    """Decode's time, plain and SDPA (given the valid-slot mask) times and
    bound at one shape, every slot of the cache valid (the step at full
    capacity)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    q = _randn(gen, (b, h, hd), q_dtype)
    k, v = (_randn(gen, (b, kv, s, hd), cache_dtype) for _ in range(2))
    kr, vr = (t.to(q_dtype).repeat_interleave(h // kv, dim=1) for t in (k, v))
    vl = torch.full((b,), s, dtype=torch.int32, device="cuda")
    mask = (torch.arange(s, device="cuda")[None] < vl[:, None])[:, None, None, :]  # the valid slots
    plan = dec.decode_plan(b, h, kv, s, hd, q_dtype, cache_dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    bound, by = decode_bound(q, k, vl, plan.route)
    e = {
        "ms": time_ms(lambda: dec.decode_attention_cuda(q, k, v, vl)),
        "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, vl)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr, attn_mask=mask)),
        "plan": {"route": plan.route, "warps": plan.warps, "stages": plan.stages, "cluster": plan.cluster,
                 "shared_bytes": plan.shared_bytes},
    }
    log(f"decode ({b},{h}->{kv},{s},{hd}) q {str(q_dtype)[6:]}, cache {str(cache_dtype)[6:]}, ratios in "
        f"this call: /SDPA {e['ms'] / e['library_ms']:.3f}, /plain {e['ms'] / e['plain_ms']:.3f}, "
        f"/bound {e['ms'] / bound:.3f} (bound {bound:.6f} ms, {by}); {e['ms']:.6f} ms, plain "
        f"{e['plain_ms']:.6f}, SDPA {e['library_ms']:.6f}; plan {e['plan']}")
    return e


def _flash_lse_entry(gen) -> dict:
    """The flash forward at orloj_gpt's (8,12,256,64) float32 without and
    with its LSE output, in turns (off, on, on, off), by graph replay."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    q, k, v = (_randn(gen, (8, 12, 256, 64), torch.float32) for _ in range(3))
    off = lambda: fa.flash_attention_cuda(q, k, v)  # noqa: E731
    on = lambda: fa.flash_attention_cuda(q, k, v, return_lse=True)  # noqa: E731
    times = [time_ms(fn) for fn in (off, on, on, off)]
    e = {"lse_off_ms": [times[0], times[3]], "lse_on_ms": [times[1], times[2]]}
    log(f"flash (8,12,256,64) f32 forward, LSE off {times[0]:.6f} / {times[3]:.6f} ms, LSE on "
        f"{times[1]:.6f} / {times[2]:.6f} ms (in turns off, on, on, off)")
    return e


def _flash_bwd_entry(gen, b, h, kv, s, hd, dtype) -> dict:
    """The flash backward at one causal shape, by graph replay: the kernel
    (``ms``), autograd through the plain version (``plain_ms``) and SDPA's
    backward on the same q, dO and the KV heads repeated (``library_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    q = _randn(gen, (b, h, s, hd), dtype)
    k, v = (_randn(gen, (b, kv, s, hd), dtype) for _ in range(2))
    dout = _randn(gen, (b, h, s, hd), dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    kernel = lambda: fa.flash_attention_backward_cuda(q, k, v, out, dout, lse)  # noqa: E731
    ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_ins = [t.detach().clone().requires_grad_(True)
               for t in (q, k.repeat_interleave(h // kv, 1), v.repeat_interleave(h // kv, 1))]
    bound, by = flash_bwd_bound(q, k, None, True, 0)
    launches = ["flash_bwd_prep_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"]
    splits = fa.backward_splits(b, h, kv, s, hd, _build.sm_count(q.device))
    if splits > 1:
        launches.append("flash_bwd_sum_kernel")
    e = {
        "ms": time_ms(kernel), "splits": splits, "own_ms": own_ms_each(kernel, launches),
        "plain_ms": grad_ms(ref.flash_attention_ref, ins, dout),
        "bound_ms": bound, "bound_by": by,
        "library_ms": grad_ms(lambda *t: F.scaled_dot_product_attention(*t, is_causal=True), lib_ins, dout),
    }
    log(f"flash backward ({b},{h}->{kv},{s},{hd}) {str(dtype)[6:]}, ratios in this call: /SDPA backward "
        f"{e['ms'] / e['library_ms']:.3f}, /plain {e['ms'] / e['plain_ms']:.3f}, /tc_bound "
        f"{e['ms'] / bound:.3f} (tc_bound {bound:.6f} ms, {by}); {e['ms']:.6f} ms, plain {e['plain_ms']:.6f}, "
        f"SDPA backward {e['library_ms']:.6f} "
        f"(all by graph replay); {splits} split(s), own durations "
        f"{', '.join(f'{n[10:-7]} {t:.6f}' for n, t in e['own_ms'].items())} ms")
    return e


def _backward_entries(gen, counts: dict[str, int], errs: dict[str, float]) -> list[dict]:
    """The three backward kernels' entries: flash at full-width orloj_gpt's
    training shape (8,12,256,64) float32 (``glm4``: GLM-4's (2,32->2,1024,128)),
    RMSNorm at GLM-4's (2048, 4096) and the gates at Arctic's (2048,128) k 2."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    f32 = torch.float32
    flash = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": counts["flash_attention_bwd"], "max_abs_err": errs["flash_attention_bwd"],
        **_flash_bwd_entry(gen, 8, 12, 12, 256, 64, f32),
        "glm4": {"max_abs_err": errs["glm4_flash_attention_bwd"],
                 **_flash_bwd_entry(gen, 2, 32, 2, 1024, 128, f32)},
        "bf16": {"max_abs_err": errs["bf16_flash_attention_bwd"],
                 **_flash_bwd_entry(gen, 8, 12, 12, 256, 64, torch.bfloat16)},
        "arctic": {"max_abs_err": errs["arctic_flash_attention_bwd"],
                   **_flash_bwd_entry(gen, 2, 56, 8, 256, 128, f32)},
    }

    x = _randn(gen, (2048, 4096), f32)
    scale, dy = _randn(gen, (4096,), f32), _randn(gen, (2048, 4096), f32)
    ins = [t.detach().clone().requires_grad_(True) for t in (x, scale)]
    bound, by = rmsnorm_bwd_bound(x)
    kernel = lambda: rms.rmsnorm_backward_cuda(x, scale, dy, eps=1e-5)  # noqa: E731
    rmsnorm = {
        "name": "rmsnorm_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:24",
        "launches": counts["rmsnorm_bwd"], "max_abs_err": errs["rmsnorm_bwd"],
        "ms": time_ms(kernel),
        "own_ms": own_ms_each(kernel, ("rmsnorm_bwd_rows_kernel", "rmsnorm_bwd_reduce_kernel")),
        "plain_ms": grad_ms(lambda x_, s_: ref.rmsnorm_ref(x_, s_, 1e-5), ins, dy),
        "bound_ms": bound, "bound_by": by,
        "library_ms": grad_ms(lambda x_, s_: F.rms_norm(x_, (4096,), weight=s_, eps=1e-5), ins, dy),
    }
    log(f"rmsnorm backward (2048,4096) f32: {rmsnorm['ms']:.6f} ms; /bound {rmsnorm['ms'] / bound:.3f} "
        f"(bound {bound:.6f} ms, {by}); /F.rms_norm backward {rmsnorm['ms'] / rmsnorm['library_ms']:.3f} "
        f"({rmsnorm['library_ms']:.6f} ms), /plain {rmsnorm['ms'] / rmsnorm['plain_ms']:.3f} "
        f"({rmsnorm['plain_ms']:.6f} ms) (all by graph replay); own durations "
        f"{', '.join(f'{n[12:-7]} {t:.6f}' for n, t in rmsnorm['own_ms'].items())} ms")

    logits = _randn(gen, (2048, 128), f32) * 2
    _, ids = gating.moe_gating_cuda(logits, 2)
    dg = _randn(gen, (2048, 2), f32)
    lg = [logits.detach().clone().requires_grad_(True)]

    def composite(x):
        top, _ = torch.topk(torch.softmax(x, dim=-1), 2, dim=-1)
        return top / top.sum(-1, keepdim=True).clamp_min(1e-9)

    bound, by = gating_bwd_bound(logits, 2)
    kernel = lambda: gating.moe_gating_backward_cuda(logits, ids, dg)  # noqa: E731
    moe = {
        "name": "moe_gating_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/moe_gating_bwd.cu",
        "replaces": "src/repro/kernels/moe_gating.py:44",
        "launches": counts["moe_gating_bwd"], "max_abs_err": errs["moe_gating_bwd"],
        "ms": time_ms(kernel),
        "own_ms": own_ms(kernel, "moe_gating_bwd_kernel"),
        "plain_ms": grad_ms(lambda x: ref.moe_gating_ref(x, 2)[0], lg, dg),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "composite_ms": grad_ms(composite, lg, dg),
    }
    log(f"moe_gating backward (2048,128) k 2 f32: {moe['ms']:.6f} ms, own duration {moe['own_ms']:.6f} ms; "
        f"bound {bound:.6f} ms ({by}); composite softmax/topk/renormalise backward {moe['composite_ms']:.6f} "
        f"ms, plain {moe['plain_ms']:.6f} ms (all by graph replay)")
    return [flash, rmsnorm, moe]


def _scan_entry(gen, counts: dict[str, int], errs: dict[str, float]) -> dict:
    """The selective scan's entry at Hymba-1.5B's largest served batch (4
    rows of 128 meta tokens and the 2048 bucket, inner width 3200) and, under
    ``b1``, at one row: its time by graph replay and its kernels' own
    durations, the plain version's (one position at a time), the torch
    doubling scan's that the card ran before the kernel (``torch_ms``), and
    the byte bound."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as sc
    from repro_torch.models import ssm

    def measure(b: int) -> dict:
        ins = _scan_inputs(gen, b, 2176, 3200)
        bound, by = scan_bound(ins[0], 16)
        kernel = lambda: sc.selective_scan_cuda(*ins)  # noqa: E731
        own = own_ms_each(kernel, ("selective_scan_runs_kernel", "selective_scan_kernel"))
        e = {"ms": time_ms(kernel, reps=5, graphs=3), "own_ms": sum(own.values()), "own_ms_each": own,
             "plain_ms": time_ms(lambda: ref.selective_scan_ref(*ins), reps=1, graphs=1),
             "torch_ms": time_ms(lambda: ssm._scan_torch(*ins, chunk=256), reps=1, graphs=1),
             "bound_ms": bound, "bound_by": by, "runs": sc.scan_plan(b, 2176, 3200, sms)}
        log(f"selective_scan ({b},2176,3200) f32: {e['ms']:.6f} ms (own {e['own_ms']:.6f} ms), /bound "
            f"{e['ms'] / bound:.3f} (bound {bound:.6f} ms, {by}); plain {e['plain_ms']:.3f} ms, torch "
            f"doubling scan {e['torch_ms']:.3f} ms (graph replays); runs {e['runs']}")
        return e

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu", "replaces": None,
        "launches": counts["selective_scan"], "max_abs_err": errs["selective_scan"], **measure(4),
        "library_ms": None,
        "b1": {"max_abs_err": errs["b1_selective_scan"], **measure(1)},
    }


def phase_kernel_line(counts: dict[str, int], errs: dict[str, float]) -> dict:
    """One entry per kernel.  Flash and decode are timed at orloj_gpt's
    (8,12,256,64) as before, under ``arctic`` at Arctic's (8,56->8,256,128),
    under ``glm4`` at GLM-4's (8,32->2,256,128), under ``toy`` at the
    engine-smoke toy's largest batch (4,4,32,16), under ``nemotron`` at
    Nemotron-4-340B's (8,96->8,256,192) and flash under ``hymba_prefix`` at
    Hymba-1.5B's largest served batch with its 128 meta tokens seen
    through the window; the selective scan at Hymba-1.5B's served shapes
    (:func:`_scan_entry`); decode also at the zoo's shapes,
    GLM-4's over its bf16 cache at 4,096 and 32,768 slots, Granite-34B's
    (4,48->1,4096,128) and DBRX's (8,48->8,256,128); RMSNorm at Arctic's
    (2048, 7168) and the gating at its (2048, 128) with k 2, and also at T
    = 8, 32 and 256 (``by_T``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    gen = torch.Generator(device="cuda").manual_seed(1)
    flash, decode = _attention_entries(gen, 8, 12, 12, 256, 64)
    a_flash, a_decode = _attention_entries(gen, 8, 56, 8, 256, 128)
    g_flash, g_decode = _attention_entries(gen, 8, 32, 2, 256, 128)
    t_flash, t_decode = _attention_entries(gen, 4, 4, 4, 32, 16)
    n_flash, n_decode = _attention_entries(gen, 8, 96, 8, 256, 192)
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": counts["flash_attention"], "max_abs_err": errs["flash_attention"], **flash,
        "arctic": {"max_abs_err": errs["arctic_flash_attention"], **a_flash},
        "glm4": {"max_abs_err": errs["glm4_flash_attention"], **g_flash},
        "toy": {"max_abs_err": errs["toy_flash_attention"], **t_flash},
        "nemotron": {"max_abs_err": errs["nemotron_flash_attention"], **n_flash},
        "hymba": {"max_abs_err": errs["hymba_flash_attention"],
                  **_flash_entry(gen, 8, 25, 5, 256, 64, torch.float32, 1024)},
        "hymba_window": {"max_abs_err": errs["hymba_window_flash_attention"],
                         **_flash_entry(gen, 1, 25, 5, 2048, 64, torch.float32, 1024)},
        "hymba_prefix": {"max_abs_err": errs["hymba_prefix_flash_attention"],
                         **_flash_entry(gen, 4, 25, 5, 2176, 64, torch.float32, 1024, prefix=128)},
        "internvl2": {"max_abs_err": errs["internvl2_flash_attention"],
                      **_flash_entry(gen, 8, 14, 2, 256, 64, torch.float32)},
        "musicgen": {"max_abs_err": errs["musicgen_flash_attention"],
                     **_flash_entry(gen, 8, 32, 32, 256, 64, torch.bfloat16)},
    }
    decode = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:80",
        "launches": counts["decode_attention"], "max_abs_err": errs["decode_attention"], **decode,
        "arctic": {"max_abs_err": errs["arctic_decode_attention"], **a_decode},
        "glm4": {"max_abs_err": errs["glm4_decode_attention"],
                 "bf16_cache_max_abs_err": errs["glm4_bf16_cache_decode_attention"], **g_decode},
        "toy": {"max_abs_err": errs["toy_decode_attention"], **t_decode},
        "nemotron": {"max_abs_err": errs["nemotron_decode_attention"], **n_decode},
        "hymba": {"max_abs_err": errs["hymba_decode_attention"],
                  **_decode_entry(gen, 8, 25, 5, 1024, 64, torch.float32, torch.bfloat16)},
        "internvl2": {"max_abs_err": errs["internvl2_decode_attention"],
                      **_decode_entry(gen, 8, 14, 2, 256, 64, torch.float32, torch.float32)},
        "musicgen": {"max_abs_err": errs["musicgen_decode_attention"],
                     **_decode_entry(gen, 8, 32, 32, 256, 64, torch.bfloat16, torch.bfloat16)},
        "xlstm": {"max_abs_err": errs["xlstm_decode_attention"],
                  **_decode_entry(gen, 8, 4, 4, 256, 512, torch.float32, torch.float32)},
        "glm4_4096_bf16_cache": {"max_abs_err": errs["glm4_4096_decode_attention"],
                                 **_decode_entry(gen, 8, 32, 2, 4096, 128, torch.float32, torch.bfloat16)},
        "glm4_32768_bf16_cache": {"max_abs_err": errs["glm4_32768_decode_attention"],
                                  **_decode_entry(gen, 8, 32, 2, 32768, 128, torch.float32, torch.bfloat16)},
        "granite": {"max_abs_err": errs["granite_decode_attention"],
                    **_decode_entry(gen, 4, 48, 1, 4096, 128, torch.float32, torch.float32)},
        "dbrx": {"max_abs_err": errs["dbrx_decode_attention"],
                 **_decode_entry(gen, 8, 48, 8, 256, 128, torch.float32, torch.float32)},
    }
    flash["lse"] = _flash_lse_entry(gen)

    x = _randn(gen, (2048, 7168), torch.float32)
    scale = _randn(gen, (7168,), torch.float32)
    r_bound, r_by = rmsnorm_bound(x)
    rmsnorm = {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:24",
        "launches": counts["rmsnorm"], "max_abs_err": errs["rmsnorm"],
        "ms": time_ms(lambda: rms.rmsnorm_cuda(x, scale, eps=1e-5)),
        "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, scale, 1e-5)),
        "bound_ms": r_bound, "bound_by": r_by,
        "library_ms": time_ms(lambda: F.rms_norm(x, (7168,), weight=scale, eps=1e-5)),
    }
    xh, sh = _randn(gen, (2048, 1600), torch.float32), _randn(gen, (1600,), torch.float32)
    h_bound, h_by = rmsnorm_bound(xh)
    rmsnorm["hymba"] = {
        "max_abs_err": errs["hymba_rmsnorm"],
        "ms": time_ms(lambda: rms.rmsnorm_cuda(xh, sh, eps=1e-5)),
        "plain_ms": time_ms(lambda: ref.rmsnorm_ref(xh, sh, 1e-5)),
        "bound_ms": h_bound, "bound_by": h_by,
        "library_ms": time_ms(lambda: F.rms_norm(xh, (1600,), weight=sh, eps=1e-5)),
    }
    log(f"rmsnorm (2048,1600) f32 (Hymba's (8,256) batch): {rmsnorm['hymba']['ms']:.6f} ms, /bound "
        f"{rmsnorm['hymba']['ms'] / h_bound:.3f} (bound {h_bound:.6f} ms, {h_by}), /F.rms_norm "
        f"{rmsnorm['hymba']['ms'] / rmsnorm['hymba']['library_ms']:.3f}")

    # The gating over Arctic's serve range (T = 32 .. 2048 rows of 128
    # experts, k 2) and one block's worth (T = 8, its latency floor): the
    # time between graph-replayed launches and the kernel's own duration.
    by_t = []
    for t in (8, 32, 256, 2048):
        lg = _randn(gen, (t, 128), torch.float32) * 2
        bound, by = gating_bound(lg, 2)
        by_t.append({
            "T": t, "ms": time_ms(lambda lg=lg: gating.moe_gating_cuda(lg, 2)),
            "own_ms": own_ms(lambda lg=lg: gating.moe_gating_cuda(lg, 2), "moe_gating_kernel"),
            "bound_ms": bound, "bound_by": by,
        })
        log(f"moe_gating ({t},128) k 2 f32: graph replay {by_t[-1]['ms']:.6f} ms, own duration "
            f"{by_t[-1]['own_ms']:.6f} ms, bound {bound:.6f} ms ({by})")
    logits = lg  # (2048, 128)

    def composite():  # softmax -> topk -> renormalise: no single call does all three
        g, i = torch.topk(torch.softmax(logits, dim=-1), 2, dim=-1)
        return g / g.sum(-1, keepdim=True).clamp_min(1e-9), i

    moe_gating = {
        "name": "moe_gating", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gating.cu",
        "replaces": "src/repro/kernels/moe_gating.py:44",
        "launches": counts["moe_gating"], "max_abs_err": errs["moe_gating"],
        "ms": by_t[-1]["ms"], "own_ms": by_t[-1]["own_ms"],
        "plain_ms": time_ms(lambda: ref.moe_gating_ref(logits, 2)),
        "bound_ms": by_t[-1]["bound_ms"], "bound_by": by_t[-1]["bound_by"],
        "library_ms": None, "composite_ms": time_ms(composite), "by_T": by_t,
    }
    entries = [flash, decode, rmsnorm, moe_gating, _scan_entry(gen, counts, errs),
               *_backward_entries(gen, counts, errs)]
    for e in entries:  # the decode ≡ forward paths' own calls, held against the plain versions
        e["path_calls_held"], e["path_max_abs_err"] = PATH_HELD.get(e["name"], (0, None))
    return {"kernels": entries}


def _release() -> None:
    """Return the memory of what the caller has just deleted to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


GRAPH_SHAPES = ((1, 32), (8, 256))  # the smallest and the largest served shape


def run_orloj_gpt(ecfg) -> list[dict[str, int]]:
    """The dense path: full-width orloj_gpt."""
    from repro_torch.configs.orloj_gpt import CONFIG
    from repro_torch.serving.engine import TorchServingEngine

    t0 = time.perf_counter()
    engine = TorchServingEngine(CONFIG, ecfg, seed=0)
    _check_no_grad(engine.params, "orloj_gpt")
    n_params = engine.model.param_count(engine.params)
    log(f"serve: {CONFIG.name} {CONFIG.n_layers} layers, d {CONFIG.d_model}, "
        f"{n_params} params, computing in float32 (built in {time.perf_counter() - t0:.1f} s)")
    windows = [phase_serve(engine, ecfg, "serve", ("flash_attention",))]
    phase_graphs(engine, "orloj_gpt", GRAPH_SHAPES)
    phase_card_vs_cpu(engine.model, engine.params, "serve")
    windows.append(phase_tokens(engine, "orloj_gpt"))
    windows.append(phase_decode_matches_forward(engine.model, engine.params, "orloj_gpt"))
    phase_where_time_goes(engine, "orloj_gpt")
    del engine
    _release()
    return windows


def run_arctic(ecfg) -> list[dict[str, int]]:
    """The MoE path: Snowflake Arctic at full width, cut to ARCTIC_LAYERS."""
    import torch

    from repro_torch.configs.arctic_480b import CONFIG
    from repro_torch.models import Model
    from repro_torch.serving.engine import TorchServingEngine

    cfg = dataclasses.replace(CONFIG, n_layers=ARCTIC_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchServingEngine(cfg, ecfg, seed=0)
    torch.cuda.synchronize()
    _check_no_grad(engine.params, "arctic")
    n_params = engine.model.param_count(engine.params)
    n_bytes = _nbytes(engine.params)
    log(f"arctic: {cfg.name} cut to {cfg.n_layers} of {CONFIG.n_layers} layers at full width: d {cfg.d_model}, "
        f"{cfg.n_heads} query heads on {cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} (d_ff {cfg.d_ff}) beside a dense {cfg.mlp}, "
        f"vocab {cfg.vocab_size}; {n_params} params, {n_bytes} bytes of float32 weights held; "
        f"peak {torch.cuda.max_memory_allocated()} bytes after init "
        f"(built in {time.perf_counter() - t0:.1f} s)")
    windows = [phase_serve(engine, ecfg, "arctic", ("rmsnorm", "moe_gating", "flash_attention"))]
    log(f"arctic: peak {torch.cuda.max_memory_allocated()} bytes after serving")
    phase_graphs(engine, "arctic", GRAPH_SHAPES)

    # The 56 GB model does not go to the host: the card-vs-CPU check runs a
    # full-width layer with 8 experts and a 512-word vocabulary.
    small = dataclasses.replace(cfg, n_experts=8, vocab_size=512)
    model = Model(small, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    _check_no_grad(params, "arctic card vs CPU")
    log(f"arctic card vs CPU: {small.n_layers} layer at full width with {small.n_experts} experts, "
        f"vocab {small.vocab_size}: {model.param_count(params)} params")
    phase_card_vs_cpu(model, params, "arctic card vs CPU")
    del model, params
    _release()

    windows.append(phase_tokens(engine, "arctic"))
    windows.append(phase_decode_matches_forward(engine.model, engine.params, "arctic"))
    if windows[-1]["moe_gating"] <= 0:
        raise SystemExit("arctic decode ≡ forward: no moe_gating kernel was launched")
    phase_where_time_goes(engine, "arctic")
    log(f"arctic: peak {torch.cuda.max_memory_allocated()} bytes over the whole Arctic phase")
    del engine
    _release()
    return windows


def run_glm4() -> list[dict[str, int]]:
    """The models' own decode path at full depth: GLM-4-9B, 40 layers at full
    width in float32 (37.6 GB of weights, which the card holds whole)."""
    import torch

    from repro_torch.configs.glm4_9b import CONFIG
    from repro_torch.models import Model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(CONFIG, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    _check_no_grad(params, "glm4")
    log(f"glm4: {CONFIG.name} {CONFIG.n_layers} layers at full width: d {CONFIG.d_model}, "
        f"{CONFIG.n_heads} query heads on {CONFIG.n_kv_heads} KV heads of {CONFIG.resolved_head_dim}, "
        f"{CONFIG.mlp} d_ff {CONFIG.d_ff}, vocab {CONFIG.vocab_size}; {model.param_count(params)} params, "
        f"{_nbytes(params)} bytes of float32 weights; peak {torch.cuda.max_memory_allocated()} bytes "
        f"after init (built in {time.perf_counter() - t0:.1f} s)")
    windows = [phase_decode_matches_forward(model, params, "glm4")]
    phase_decode_step_time(model, params, "glm4")
    log(f"glm4: peak {torch.cuda.max_memory_allocated()} bytes over decode ≡ forward and the timed steps")
    del model, params
    _release()
    phase_step_card_vs_cpu(dataclasses.replace(CONFIG, n_layers=1, vocab_size=512), "glm4 card vs CPU")
    _release()
    return windows


NEMOTRON_LAYERS = 1  # 51.6 GB of float32 weights at one layer (2 × 4.72 G in embedding and head)


def _check_no_grad(params, label: str) -> None:
    """The kernels refuse inputs that require grad while grad mode is on;
    the serving and decode paths run under no_grad and with parameters that
    require none.  Checked on every path, so that the refusal cannot trip one."""
    if any(t.requires_grad for t in _leaves(params)):
        raise SystemExit(f"{label}: a parameter requires grad")


def run_nemotron() -> list[dict[str, int]]:
    """Head size 192 on a model path: Nemotron-4-340B at full width (d 18432,
    96 query heads on 8 KV heads of 192, relu2 d_ff 73728, vocab 256000) cut
    to NEMOTRON_LAYERS, in float32: decode ≡ forward, every kernel call held."""
    import torch

    from repro_torch.configs.nemotron_4_340b import CONFIG
    from repro_torch.models import Model

    cfg = dataclasses.replace(CONFIG, n_layers=NEMOTRON_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    _check_no_grad(params, "nemotron")
    log(f"nemotron: {cfg.name} cut to {cfg.n_layers} of {CONFIG.n_layers} layers at full width: "
        f"d {cfg.d_model}, {cfg.n_heads} query heads on {cfg.n_kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, {cfg.mlp} d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (uncut); "
        f"{model.param_count(params)} params, {_nbytes(params)} bytes of float32 weights; peak "
        f"{torch.cuda.max_memory_allocated()} bytes after init (built in {time.perf_counter() - t0:.1f} s)")
    windows = [phase_decode_matches_forward(model, params, "nemotron")]
    log(f"nemotron: peak {torch.cuda.max_memory_allocated()} bytes over decode ≡ forward")
    del model, params
    _release()
    return windows


HYMBA_WRAP_LAYERS, HYMBA_WRAP_TOKENS = 2, 1100  # past the 1024-slot ring at full width
GEMM_NAMES = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "splitK")


def _by_class(events) -> dict[str, float]:
    """Device ms of a profile's operations by class: the flash, rmsnorm and
    selective-scan kernels, the GEMMs, and everything else."""
    kernels = ("flash_attention", "rmsnorm", "selective_scan")
    out = {"gemm": 0.0, **{k: 0.0 for k in kernels}, "other": 0.0}
    for e in events:
        cls = next((k for k in kernels if k in e.key and "_kernel" in e.key), None)
        if cls is None:
            cls = "gemm" if any(n in e.key for n in GEMM_NAMES) else "other"
        out[cls] += e.device_time_total / 1e3
    return out


def phase_hymba_prefill(engine) -> None:
    """Where Hymba's (8, 256) prefill spends the card's time: the profile by
    class (GEMMs, flash, rmsnorm, the selective scan, the rest), one layer's
    Mamba branch alone and its selective-scan kernel alone (the forward runs
    32 of each), and the prefill's peak memory above the weights (an eager
    forward's: a replay runs in its graph's memory pool, held since the
    capture)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import ssm

    cfg = engine.model.cfg
    tokens = np.ones((8, 256), np.int32)
    engine.executor._run(tokens)  # warm
    ms, _ = engine.executor._run(tokens)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():  # the replay allocates nothing: its graph's pool is held
        engine.model.logits(engine.params, {"tokens": torch.ones((8, 256), dtype=torch.long, device="cuda")})
    peak = torch.cuda.max_memory_allocated() - base
    log(f"hymba prefill (8,256): replay {ms:.4f} ms on the host's clock; an eager forward's peak {peak} "
        f"bytes above the {base} bytes held before it")
    classes = _by_class(_profile(lambda: engine.executor._run(tokens), "hymba", "prefill (8,256)"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    h = _randn(gen, (8, 256, cfg.d_model), torch.float32)
    mp = engine.params["blocks"][0]["mamba"]
    ins = _scan_inputs(gen, 8, 256, mp["in_x"].shape[1])
    with torch.no_grad():
        branch = sum(e.device_time_total for e in _profile(
            lambda: ssm.mamba_apply(mp, h, cfg.mlstm_chunk), "hymba",
            f"one layer's Mamba branch (8,256,{cfg.d_model})"))
        scan = sum(e.device_time_total for e in _profile(
            lambda: ops.selective_scan(*ins), "hymba",
            f"one layer's selective scan (8,256,{ins[0].shape[2]},{cfg.ssm_state})"))
    del h, ins
    log(f"hymba where the time goes: prefill (8,256) device ms by class: "
        + ", ".join(f"{k} {v:.4f}" for k, v in classes.items())
        + f"; one layer's Mamba branch {branch / 1e3:.4f} ms (x{cfg.n_layers} = "
        f"{cfg.n_layers * branch / 1e3:.4f}), of which its selective scan {scan / 1e3:.4f} ms "
        f"(x{cfg.n_layers} = {cfg.n_layers * scan / 1e3:.4f})")


def run_hymba(ecfg) -> list[dict[str, int]]:
    """The first zoo model with a sliding window on the card: Hymba-1.5B at
    full width and depth (32 layers, d 1600, 25 query heads on 5 KV heads of
    64, Mamba heads of state 16, window 1024) served under Orloj, its token
    path, decode ≡ forward over 16 tokens, the prefill's breakdown, then two
    layers at full width across the 1024-slot ring's wrap."""
    import torch

    from repro_torch.configs.hymba_1_5b import CONFIG
    from repro_torch.models import Model
    from repro_torch.serving.engine import TorchServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchServingEngine(CONFIG, ecfg, seed=0)
    torch.cuda.synchronize()
    _check_no_grad(engine.params, "hymba")
    log(f"hymba: {CONFIG.name} {CONFIG.n_layers} layers at full width: d {CONFIG.d_model}, "
        f"{CONFIG.n_heads} query heads on {CONFIG.n_kv_heads} KV heads of {CONFIG.resolved_head_dim}, "
        f"window {CONFIG.sliding_window}, Mamba state {CONFIG.ssm_state}, {CONFIG.mlp} d_ff {CONFIG.d_ff}, "
        f"vocab {CONFIG.vocab_size}; {engine.model.param_count(engine.params)} params, "
        f"{_nbytes(engine.params)} bytes of float32 weights; peak {torch.cuda.max_memory_allocated()} "
        f"bytes after init (built in {time.perf_counter() - t0:.1f} s)")
    windows = [phase_serve(engine, ecfg, "hymba", ("rmsnorm", "flash_attention", "selective_scan"))]
    log(f"hymba: peak {torch.cuda.max_memory_allocated()} bytes after serving")
    phase_graphs(engine, "hymba", GRAPH_SHAPES)
    windows.append(phase_tokens(engine, "hymba"))
    windows.append(phase_decode_matches_forward(engine.model, engine.params, "hymba", prompt=16))
    phase_hymba_prefill(engine)
    del engine
    _release()

    cfg = dataclasses.replace(CONFIG, n_layers=HYMBA_WRAP_LAYERS)
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(3))
    _check_no_grad(params, "hymba ring wrap")
    windows.append(phase_decode_matches_forward(
        model, params, f"hymba ring wrap ({cfg.n_layers} layers)", prompt=HYMBA_WRAP_TOKENS, rows=1))
    del model, params
    _release()
    return windows


def phase_logits(model, params, label: str, batch: dict, dtype=None) -> dict[str, int]:
    """One forward on the card over ``batch``: finite logits of the expected
    shape (and of ``dtype``, float32 if None), its launches, every kernel
    call held against its plain version."""
    import torch

    from repro_torch.kernels import ops

    cfg = model.cfg
    seq = sum(v.shape[1] for k, v in batch.items() if k in ("tokens", "frontend_embeds"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), _kernel_log() as calls:
        got = model.logits(params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ok = (got.shape == (next(iter(batch.values())).shape[0], seq, cfg.vocab_size)
          and got.dtype == (dtype or torch.float32) and bool(torch.isfinite(got).all()))
    log(f"{label}: logits {tuple(got.shape)} {str(got.dtype)[6:]} finite={ok}, max |logit| "
        f"{got.float().abs().max().item():.3f} ({time.perf_counter() - t0:.2f} s with the holds); "
        f"launches={counts}")
    if not ok:
        raise SystemExit(f"{label}: logits {tuple(got.shape)} {got.dtype}, not all finite or not of the "
                         f"expected shape and type")
    _hold_path_calls(calls, label)
    return counts


def run_xlstm(ecfg) -> list[dict[str, int]]:
    """The recurrent model: xLSTM-1.3B at full width and depth (48 blocks, d
    2048, 4 heads of 512, every 8th block an sLSTM), whose model path
    launches none of the kernels: decode ≡ forward, and the (8, 256)
    forward's seconds, device operations and idle share, beside one sLSTM
    block's.  Its token path prices a decode step at d / n_heads = 512 (4
    query heads on 4 KV heads): served through the engine, every decode
    call held against the plain version."""
    import torch

    from repro_torch.configs.xlstm_1_3b import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ssm
    from repro_torch.serving.engine import TorchServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(CONFIG, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    _check_no_grad(params, "xlstm")
    log(f"xlstm: {CONFIG.name} {CONFIG.n_layers} blocks at full width: d {CONFIG.d_model}, "
        f"{CONFIG.n_heads} heads of {CONFIG.d_model // CONFIG.n_heads}, one sLSTM block in every "
        f"{CONFIG.slstm_every}, vocab {CONFIG.vocab_size}; {model.param_count(params)} params, {_nbytes(params)} bytes "
        f"of float32 weights; peak {torch.cuda.max_memory_allocated()} bytes after init "
        f"(built in {time.perf_counter() - t0:.1f} s); its model path launches none of the kernels")
    windows = [phase_decode_matches_forward(model, params, "xlstm", must_launch=())]
    engine = TorchServingEngine(CONFIG, ecfg, seed=0, params=params)
    windows.append(phase_tokens(engine, "xlstm (decode at head size 512)", hold=True))
    del engine
    tokens = torch.ones((8, 256), dtype=torch.long, device="cuda")

    def forward():
        with torch.no_grad():
            model.logits(params, {"tokens": tokens})

    forward()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ops.reset_launch_counts()
    forward()
    torch.cuda.synchronize()
    windows.append(ops.launch_counts())
    log(f"xlstm forward (8,256): {sorted(times)[1]:.4f} s median of 3 on the host's clock "
        f"(min {min(times):.4f}, max {max(times):.4f}); launches={windows[-1]}")
    if any(windows[-1].values()):
        raise SystemExit("xlstm: the forward launched a kernel, and it has none")
    _profile(forward, "xlstm", "forward (8,256)")
    slstm = next(i for i in range(CONFIG.n_layers) if CONFIG.slstm_every - 1 == i % CONFIG.slstm_every)
    h = _randn(torch.Generator(device="cuda").manual_seed(5), (8, 256, CONFIG.d_model), torch.float32)
    with torch.no_grad():
        _profile(lambda: ssm.slstm_apply(params["blocks"][slstm]["cell"], h, CONFIG.n_heads),
                 "xlstm", f"one sLSTM block's cell (8,256,{CONFIG.d_model}), 256 sequential steps")
    log(f"xlstm: peak {torch.cuda.max_memory_allocated()} bytes over the xLSTM phase")
    del model, params, h
    _release()
    return windows


def run_internvl2() -> list[dict[str, int]]:
    """The vision frontend: InternVL2-1B at full width and depth (24 layers,
    d 896, 14 query heads on 2 KV heads of 64, vocab 151655): logits over 256
    patch embeddings and 64 tokens, decode ≡ forward (flash and decode at a
    group of 7), then one layer with a 512-word vocabulary against the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs.internvl2_1b import CONFIG
    from repro_torch.models import Model

    torch.cuda.reset_peak_memory_stats()
    model = Model(CONFIG, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    _check_no_grad(params, "internvl2")
    log(f"internvl2: {CONFIG.name} {CONFIG.n_layers} layers at full width: d {CONFIG.d_model}, "
        f"{CONFIG.n_heads} query heads on {CONFIG.n_kv_heads} KV heads of {CONFIG.resolved_head_dim}, "
        f"vision prefix of {CONFIG.n_frontend_tokens} embeddings of {model.frontend_dim}, vocab "
        f"{CONFIG.vocab_size}; {model.param_count(params)} params, {_nbytes(params)} bytes of float32 weights")
    rng = np.random.default_rng(6)
    batch = {
        "frontend_embeds": torch.from_numpy(
            rng.normal(size=(2, CONFIG.n_frontend_tokens, 1024)).astype(np.float32)).cuda(),
        "tokens": torch.from_numpy(rng.integers(0, CONFIG.vocab_size, size=(2, 64))).cuda(),
    }
    label = f"internvl2 logits ({CONFIG.n_frontend_tokens} patches + 64 tokens)"
    windows = [phase_logits(model, params, label, batch)]
    windows.append(phase_decode_matches_forward(model, params, "internvl2"))
    log(f"internvl2: peak {torch.cuda.max_memory_allocated()} bytes")
    del model, params, batch
    _release()
    # The config projects the prefix in bfloat16: the card's GEMM and the
    # CPU's may round a sum on either side of a bf16 step.  So the logits
    # are held with the prefix in float32, and the bf16 prefix on its own.
    small = dataclasses.replace(CONFIG, n_layers=1, vocab_size=512)
    model = Model(dataclasses.replace(small, dtype="float32"), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    phase_card_vs_cpu(model, params, "internvl2 card vs CPU (1 layer, vocab 512, prefix in float32)")
    embeds = torch.from_numpy(rng.normal(size=(2, CONFIG.n_frontend_tokens, 1024)).astype(np.float32))
    with torch.no_grad():
        got = Model(small, device="cuda")._project_frontend(params, embeds.cuda()).cpu().float()
        want = Model(small, device="cpu")._project_frontend(_to_cpu(params), embeds).float()
    err = (got - want).abs().max().item()
    ok = bool(torch.isclose(got, want, rtol=2**-7, atol=1e-4).all())
    log(f"internvl2 card vs CPU: the bf16 prefix projection {tuple(got.shape)}: max_abs_err {err:.3e}, "
        f"max |value| {want.abs().max().item():.3f} (rtol 2**-7, atol 1e-4: one bf16 step) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("internvl2: the bf16 prefix projection on the card disagrees with the CPU's")
    del model, params
    _release()
    return windows


def run_musicgen() -> list[dict[str, int]]:
    """The first model that computes in bfloat16: MusicGen-large at full
    width and depth (48 layers, d 2048, 32 heads of 64, gelu d_ff 8192),
    weights in float32, audio frames projected in bfloat16 with no token
    embedding: logits over 256 frames, decode ≡ forward over a bf16 cache
    (the bf16 flash and bf16/bf16 decode instantiations)."""
    import numpy as np
    import torch

    from repro_torch.configs.musicgen_large import CONFIG
    from repro_torch.models import Model

    torch.cuda.reset_peak_memory_stats()
    model = Model(CONFIG, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    _check_no_grad(params, "musicgen")
    log(f"musicgen: {CONFIG.name} {CONFIG.n_layers} layers at full width: d {CONFIG.d_model}, "
        f"{CONFIG.n_heads} heads of {CONFIG.resolved_head_dim}, {CONFIG.mlp} d_ff {CONFIG.d_ff}, "
        f"frames of {model.frontend_dim}, vocab {CONFIG.vocab_size}, computing in {CONFIG.dtype}; "
        f"{model.param_count(params)} params, {_nbytes(params)} bytes of float32 weights")
    frames = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 256, 512)).astype(np.float32))
    windows = [phase_logits(model, params, "musicgen logits (256 frames)", {"frontend_embeds": frames.cuda()},
                            dtype=torch.bfloat16)]
    windows.append(phase_decode_matches_forward(model, params, "musicgen"))
    log(f"musicgen: peak {torch.cuda.max_memory_allocated()} bytes")
    del model, params
    _release()
    return windows


ENGINE_SMOKE_ARTIFACT = ROOT / "build" / "BENCH_eval_torch_chip_smoke.json"


def run_engine_smoke() -> list[dict[str, int]]:
    """The paper's real-engine evaluation on the card: ``grid.engine_smoke()``
    (bimodal, ORLOJ against Nexus at SLO 1.5 and 5, 48 requests a cell)
    through the port's ``runner.run_specs``, on the toy ``orloj_gpt`` (d 64
    over 4 heads: flash at head_dim 16) and then the same 4 specs on
    ``engine:orloj_gpt_paper`` (full width, 12 layers, d 768: flash at
    head_dim 64).  Each cell is its own launch window (the first of a model
    also builds and profiles its engine).  Then each model's replayed
    logits are held against eager ones (:func:`phase_graphs`), and one cell
    of each model is served again on a new engine with every flash call
    recorded and held against the plain version (each served shape's eager
    warm-up: the replays make no call); those runs are outside the windows.
    Writes the artifact under build/ and prints the drift report per model."""
    import numpy as np

    from repro_torch.eval import evaluate_claims, runner, substrate
    from repro_torch.eval.grid import engine_smoke
    from repro_torch.kernels import ops

    substrate.set_engine_device("cuda")
    specs = engine_smoke()
    models = {"orloj_gpt": specs,
              "orloj_gpt_paper": [dataclasses.replace(s, substrate="engine:orloj_gpt_paper",
                                                      tag=s.tag.replace("engine/", "engine:paper/"))
                                  for s in specs]}
    windows, results = [], []
    for model, cells in models.items():
        for spec in cells:
            ops.reset_launch_counts()
            (r,) = runner.run_specs([spec], jobs=1)
            counts = ops.launch_counts()
            windows.append(counts)
            results.append(r)
            m = r.substrate_meta
            log(f"engine-smoke {model} {spec.tag}: finish {r.finish_rate:.4f}, sim twin "
                f"{m['sim_twin']['finish_rate']:.4f}, finish_rate_drift {m['finish_rate_drift']:+.4f}, "
                f"batch_mape {m['batch_mape']:.4f}, batches {m['n_batches']}, c0 {m['c0_ms']:.4f} ms, "
                f"c1 {m['c1_ms_per_token'] * 1e3:.5f} ms/ktok, p50 {r.latency_p50_ms:.4f} ms, "
                f"p99 {r.latency_p99_ms:.4f} ms; flash launches {counts['flash_attention']} "
                f"(window: {counts}); {r.wall_s:.2f} s")
            if r.n_total != spec.n_requests or m["n_batches"] <= 0 or counts["flash_attention"] <= 0:
                raise SystemExit(f"engine-smoke {spec.tag}: {r.n_total} requests, {m['n_batches']} "
                                 f"batches, {counts['flash_attention']} flash launches")
        engine, _ = substrate._get_engine(model)
        cfg = engine.model.cfg
        _check_no_grad(engine.params, f"engine-smoke {model}")
        want_hd = 16 if model == "orloj_gpt" else 64
        log(f"engine-smoke {model}: {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} "
            f"heads of {cfg.resolved_head_dim}, buckets {list(engine.cfg.buckets)}, batches "
            f"{list(engine.cfg.batch_sizes)}, {engine.model.param_count(engine.params)} params")
        if cfg.resolved_head_dim != want_hd:
            raise SystemExit(f"engine-smoke {model}: head_dim {cfg.resolved_head_dim}, not {want_hd}")
        big = max(engine.cfg.batch_sizes), max(engine.cfg.buckets)
        phase_graphs(engine, f"engine-smoke {model}", ((1, 32), big))
        # Every flash call the host makes for one cell, on its own inputs,
        # against the plain version: served again on a new engine, whose
        # shapes' eager warm-ups (in its profile) make those calls; the
        # captured graphs' replays make none.
        del engine
        substrate._ENGINE_CACHE.clear()
        _release()
        with _kernel_log() as calls:
            runner.run_specs([cells[0]], jobs=1)
        flash_calls = [c for c in calls if c[0] == "flash_attention"]
        if not flash_calls:
            raise SystemExit(f"engine-smoke {model}: the held run made no flash call")
        _hold_path_calls(flash_calls, f"engine-smoke {model} {cells[0].tag} (served again on a new engine, "
                                      f"each shape's warm-up)")
        del calls, flash_calls
        if model == "orloj_gpt":
            engine, _ = substrate._get_engine(model)
            tokens = np.ones(big, np.int32)
            _profile(lambda: engine.executor._run(tokens), "engine-smoke orloj_gpt",
                     f"prefill {big} (the toy's largest batch)")
            del engine

    claims = evaluate_claims(results)
    drift = substrate.drift_report(results)
    ENGINE_SMOKE_ARTIFACT.parent.mkdir(parents=True, exist_ok=True)
    runner.write_artifact(str(ENGINE_SMOKE_ARTIFACT), results, grid="engine-smoke", claims=claims,
                          extra={"engine_drift": drift})
    log(f"engine-smoke: {len(results)} cells -> {ENGINE_SMOKE_ARTIFACT.relative_to(ROOT)}; claims "
        + ", ".join(f"{c.name} {'PASS' if c.passed else 'FAIL'}" for c in claims))
    for model in models:
        d = substrate.drift_report([r for r in results if r.substrate_meta["model"] == model])
        log(f"engine-smoke drift {model}: {d['n_cells']} cells, |finish-rate drift| mean "
            f"{d['mean_abs_finish_rate_drift']:.4f} max {d['max_abs_finish_rate_drift']:.4f}, "
            f"batch-time MAPE mean {d['mean_batch_mape']:.4f}")
    substrate._ENGINE_CACHE.clear()
    _release()
    return windows


# ------------------------------------------------------------ training
TRAIN_T1 = dict(steps=50, batch=8, seq=256)  # full-width orloj_gpt
GLM_TRAIN_LAYERS = 4  # GLM-4-9B at full width: 2.06 G parameters, 33 GB with grads and moments
TRAIN_T2 = dict(steps=5, batch=2, seq=1024)  # S 1024 = 2 loss chunks of 512


def _train_phase(cfg, label: str, must_launch: tuple[str, ...], **kw) -> tuple[dict[str, int], dict]:
    """``repro_torch.launch.train.train`` on the card (the CLI's body, its
    step a ``TrainProgram``: step 1 eager, then replays of its CUDA graph),
    the launch counters set to 0 just before and read just after; then its
    losses, ms/step (median of the steps after the first), the corpus's
    host share of a step, peak memory, each kernel's launches, and one more
    step, a replay, under the profiler (its batch drawn first): device busy
    time and idle share.  Then the same loop with its step eager
    (:func:`_eager_train`) beside it.  Fails on a non-finite loss, a kernel
    of ``must_launch`` that was not launched, a step that was not captured,
    or losses of the two loops further apart than T3's loss tolerance
    (1e-4 relative)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainProgram, train

    _release()
    torch.cuda.reset_peak_memory_stats()
    rec: dict = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = train(cfg, device="cuda", record=rec, **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    secs = time.perf_counter() - t0
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    TRAIN_PEAKS[label[label.index("(") + 1:label.index(")")]] = peak
    step_ms, data_ms = rec["step_ms"], rec["data_ms"]
    steady = sorted(step_ms[1:] or step_ms)
    share = sum(data_ms[1:] or data_ms) / sum(step_ms[1:] or step_ms)
    data_med = sorted(data_ms)[len(data_ms) // 2]
    log(f"{label}: {len(losses)} steps at (batch {kw['batch']}, seq {kw['seq']}) in {secs:.1f} s: loss "
        f"{losses[0]:.4f} → {losses[-1]:.4f}; ms/step median {steady[len(steady) // 2]:.2f} (min "
        f"{steady[0]:.2f}, max {steady[-1]:.2f}; first step {step_ms[0]:.2f}) on the host's clock, of which "
        f"the corpus (host) {share:.4f} of the steps' time (median {data_med:.2f} "
        f"ms a batch); peak memory {peak} bytes; launches={counts}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: a loss is not finite: {losses}")
    for name in must_launch:
        if counts[name] <= 0:
            raise SystemExit(f"{label}: the training path launched no {name} kernel")
    program = rec["train_step"]
    if not isinstance(program, TrainProgram) or program.graph is None:
        raise SystemExit(f"{label}: the train step was not captured as a CUDA graph")
    batch = next(rec["iterator"])
    params, opt_state = rec["params"], rec["opt_state"]
    events = _profile(lambda: program(params, opt_state, batch), label, "one train step (a replay)")
    busy = sum(e.device_time_total for e in events) / 1e3
    info = dict(losses=losses, step_ms=steady[len(steady) // 2], data_share=share, peak=peak,
                busy_ms=busy, first=float(np.mean(losses[: max(len(losses) // 5, 1)])),
                last=float(np.mean(losses[-max(len(losses) // 5, 1):])))
    rec.clear()
    del params, opt_state, batch, program
    _release()

    eager = _eager_train(cfg, **kw)
    e_steady = sorted(eager["step_ms"][1:] or eager["step_ms"])
    delta = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, eager["losses"], strict=True))
    same = losses == eager["losses"]
    log(f"{label}: eager → graphed on the same weights and batches, ms on the host's clock (the corpus's "
        f"draw included): first step {eager['step_ms'][0]:.2f} → {step_ms[0]:.2f} (the graphed one runs "
        f"eagerly, then captures), median of the other {len(steady)} {e_steady[len(e_steady) // 2]:.2f} → "
        f"{info['step_ms']:.2f}; the corpus {data_med:.2f} ms a batch, {share:.4f} of the graphed steps' "
        f"time; a replay's profiled device busy {busy:.2f} ms, idle share {max(0.0, 1 - busy / info['step_ms']):.3f} "
        f"of the graphed median; max_memory_allocated {eager['peak']} → {peak} bytes, memory_reserved "
        f"{eager['reserved']} → {reserved}; losses over {len(losses)} steps "
        f"{'bit-identical' if same else f'differ: max relative |Δ| {delta:.3e} (T3 tol 1e-4)'}")
    if not same and delta > 1e-4:
        raise SystemExit(f"{label}: the graphed loop's losses depart from the eager loop's")
    return counts, info


def _eager_train(cfg, *, steps: int, batch: int, seq: int) -> dict:
    """``launch.train.train``'s loop with its step eager
    (``make_train_step``, as the multi-process DTensor loop runs it) from
    the same weights (seed 0), AdamW schedule (``train``'s default lr 3e-4)
    and corpus batches: each step's loss and ms on the host's clock (the
    corpus's draw included, ending in the loss's read-back), the peak
    memory and what the allocator holds after the loop."""
    import torch

    from repro_torch.data import DataConfig, make_train_iterator
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import leaves

    _release()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    opt_state = adamw_init(params)
    step = make_train_step(model, AdamWConfig(lr=3e-4, total_steps=steps, warmup_steps=max(steps // 10, 1)))
    it = make_train_iterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch), "cuda")
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, next(it))
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out = dict(losses=losses, step_ms=step_ms, peak=torch.cuda.max_memory_allocated(),
               reserved=torch.cuda.memory_reserved())
    del model, params, opt_state, step, it, loss
    _release()
    return out


def run_train_orloj_gpt() -> list[dict[str, int]]:
    """T1: full-width orloj_gpt (12 layers, d 768, 12 heads of 64, d_ff 3072,
    vocab 32000, ~124 M parameters) trained 50 steps at (8, 256) through the
    flash forward and backward kernels (layernorm: no RMSNorm); the loss
    must improve."""
    from repro_torch.configs.orloj_gpt import CONFIG

    counts, info = _train_phase(CONFIG, "train orloj_gpt (T1)", ("flash_attention", "flash_attention_bwd"),
                                **TRAIN_T1)
    log(f"train orloj_gpt (T1): loss {info['first']:.4f} → {info['last']:.4f} "
        f"({'improved' if info['last'] < info['first'] else 'NOT improved'}); flash launches "
        f"{counts['flash_attention']} forward and {counts['flash_attention_bwd']} backward for "
        f"{CONFIG.n_layers} layers × {TRAIN_T1['steps']} steps")
    if not info["last"] < info["first"]:
        raise SystemExit("train orloj_gpt (T1): the loss did not improve")
    return [counts]


def run_train_glm4() -> list[dict[str, int]]:
    """T2: GLM-4-9B at full width (d 4096, 32 query heads on 2 KV heads of
    128, d_ff 13696, vocab 151552) cut to GLM_TRAIN_LAYERS layers, with its
    config's recomputation and loss chunks of 512: 5 steps at (2, 1024).
    RMSNorm forward and backward, flash at GQA 16:1; recomputation runs every
    block's forward again in the backward, so the forwards launch twice."""
    import torch

    from repro_torch.configs.glm4_9b import CONFIG

    cfg = dataclasses.replace(CONFIG, n_layers=GLM_TRAIN_LAYERS)
    chunks = -(-TRAIN_T2["seq"] // cfg.loss_chunk)
    log(f"train glm4 (T2): {cfg.name} cut to {cfg.n_layers} of {CONFIG.n_layers} layers at full width, "
        f"remat={cfg.remat} ({cfg.remat_policy}), loss_chunk {cfg.loss_chunk}: {chunks} chunks of the "
        f"sequence; n_params_estimate {cfg.n_params_estimate}")
    counts, info = _train_phase(cfg, "train glm4 (T2)", ("flash_attention", "flash_attention_bwd", "rmsnorm",
                                                         "rmsnorm_bwd"), **TRAIN_T2)
    per_step = {k: v / TRAIN_T2["steps"] for k, v in counts.items() if v}
    log(f"train glm4 (T2): launches a step {per_step}: flash forward {counts['flash_attention']} = 2 × "
        f"{counts['flash_attention_bwd']} backward (recomputation); peak {info['peak']} bytes "
        f"({info['peak'] / 2**30:.2f} GiB) of {torch.cuda.get_device_properties(0).total_memory} on the card")
    if counts["flash_attention"] != 2 * counts["flash_attention_bwd"]:
        raise SystemExit("train glm4 (T2): recomputation did not run each block's forward twice")
    return [counts]


def train_step_card_and_cpu(cfg, tokens, labels, lr: float = 1e-3):
    """One train step of the same weights (drawn on the card from seed 4)
    and batch on the card and on the CPU.  The card's is the replay of a
    ``launch.train.TrainProgram``'s graph: the program's first call steps
    eagerly and captures, the state is put back to the drawn weights and
    fresh moments in place, and the second call replays the captured step
    on it.  The CPU's is ``launch.train.make_train_step``.  The gradients
    for the comparison are taken first, by ``torch.autograd.grad`` of the
    same loss.  Returns each side's (loss, gradient leaves, parameters
    after the step), the launches of the card's replay, and the largest
    |Δ| between the replay's loss and parameters and the eager first
    step's."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainProgram, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import leaves

    drawn = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(4))
    side, counts, replay_delta = {}, {}, 0.0
    for dev in ("cuda", "cpu"):
        model = Model(cfg, device=dev)
        params = _tree_copy(drawn, dev)  # the update is in place: each side its own copy
        for t in leaves(params):
            t.requires_grad_(True)
        batch = {"tokens": torch.from_numpy(tokens).to(dev), "labels": torch.from_numpy(labels).to(dev)}
        grads = torch.autograd.grad(model.loss(params, batch), leaves(params), allow_unused=True,
                                    materialize_grads=True)
        opt = AdamWConfig(lr=lr, total_steps=10, warmup_steps=1)
        opt_state = adamw_init(params)
        if dev == "cuda":
            program = TrainProgram(model, opt, params, opt_state, tuple(tokens.shape))
            _, _, eager_loss = program(params, opt_state, batch)
            eager = [float(eager_loss)] + [t.detach().clone() for t in leaves(params)]
            with torch.no_grad():
                for t, t0 in zip(leaves(params), leaves(drawn), strict=True):
                    t.copy_(t0)
                for t in leaves(opt_state["m"]) + leaves(opt_state["v"]) + [opt_state["step"]]:
                    t.zero_()
            ops.reset_launch_counts()
            _, _, loss = program(params, opt_state, batch)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            if program.graph is None:
                raise SystemExit(f"{cfg.name}: the train step was not captured")
            replay_delta = max([abs(float(loss) - eager[0])] + [
                (t.detach() - t0).abs().max().item() for t, t0 in zip(leaves(params), eager[1:], strict=True)])
            del program, eager
        else:
            params, _, loss = make_train_step(model, opt)(params, opt_state, batch)
        side[dev] = (float(loss), [g.cpu() for g in grads], [t.detach().cpu() for t in leaves(params)])
        del model, params, grads, opt_state
    del drawn
    _release()
    return side["cuda"], side["cpu"], counts, replay_delta


def train_step_errors(card, cpu, lr: float) -> dict:
    """How far the card's train step lies from the CPU's, and whether within
    tolerance (``ok``): the loss to 1e-4 relative; the global gradient norm
    to 1e-4 relative; every gradient leaf to 1e-3 of its largest |g| (at
    least 1) (float32 on both sides, the kernels summing in other orders);
    the parameters after the step, which moves each by lr·(g/(|g|+eps) +
    wd·p): to 1e-5 relative where the CPU's |g| is above 1e-2 of its leaf's
    largest (the step's sign is settled there), and within 2·lr elsewhere."""
    import torch

    (l1, g1, p1), (l2, g2, p2) = card, cpu
    n1, n2 = (float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))) for gs in (g1, g2))
    grad_err = max(((a - b).abs().max() / max(1.0, b.abs().max().item())).item()
                   for a, b in zip(g1, g2, strict=True))
    settled_err, loose_err, n_settled, n_all = 0.0, 0.0, 0, 0
    for a, b, g in zip(p1, p2, g2, strict=True):
        settled = g.abs() > 1e-2 * g.abs().max()
        d = (a - b).abs()
        if settled.any():
            settled_err = max(settled_err, (d[settled] / (1 + b.abs()[settled])).max().item())
        loose_err = max(loose_err, d.max().item())
        n_settled += int(settled.sum())
        n_all += settled.numel()
    ok = (abs(l1 - l2) <= 1e-4 * abs(l2) and abs(n1 - n2) <= 1e-4 * abs(n2) and grad_err <= 1e-3
          and settled_err <= 1e-5 and loose_err <= 2 * lr + 1e-6)
    return {"loss": (l1, l2), "grad_norm": (n1, n2), "grad_err": grad_err, "settled_err": settled_err,
            "loose_err": loose_err, "settled": (n_settled, n_all), "ok": ok}


def _train_step_pair(cfg, label: str, rows: int, seq: int, lr: float = 1e-3) -> dict[str, int]:
    """T3/T4: :func:`train_step_card_and_cpu` on a seeded batch, held by
    :func:`train_step_errors`.  Returns the launches of the card's replayed
    step."""
    import numpy as np

    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, size=(rows, seq))
    labels = rng.integers(0, cfg.vocab_size, size=(rows, seq))
    labels[0, :5] = -1
    card, cpu, counts, replay_delta = train_step_card_and_cpu(cfg, tokens, labels, lr)
    e = train_step_errors(card, cpu, lr)
    (l1, l2), (n1, n2) = e["loss"], e["grad_norm"]
    log(f"{label}: one train step at ({rows}, {seq}), the card's graph replayed (max |Δ| to the eager "
        f"step on the same state {replay_delta:.3e}) vs CPU: loss {l1:.6f} vs {l2:.6f}, gradient "
        f"norm {n1:.6f} vs {n2:.6f}, gradient leaves max err {e['grad_err']:.3e} of the leaf's largest (tol "
        f"1e-3); parameters after the AdamW step: {e['settled'][0]} of {e['settled'][1]} with a settled "
        f"sign, max err {e['settled_err']:.3e} (tol 1e-5), all within {e['loose_err']:.3e} (tol 2·lr = "
        f"{2 * lr}); card launches { {k: v for k, v in counts.items() if v} } {'ok' if e['ok'] else 'FAIL'}")
    if not e["ok"]:
        raise SystemExit(f"{label}: the train step on the card disagrees with the CPU's")
    return counts


def _tree_copy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_copy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


def run_train_card_vs_cpu() -> list[dict[str, int]]:
    """T3: one train step card against CPU at GLM-4-9B's widths cut to 1
    layer and a 512-word vocabulary, and at full-width orloj_gpt.  T4: the
    same at Arctic ``.reduced(n_experts=16)`` (the gates' backward through the
    MoE block) and Hymba ``.reduced()`` (window 64 < S 96: the windowed
    flash backward)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.glm4_9b import CONFIG as GLM
    from repro_torch.configs.orloj_gpt import CONFIG as GPT

    need = {
        "glm4": ("flash_attention_bwd", "rmsnorm_bwd"),
        "orloj_gpt": ("flash_attention_bwd",),
        "arctic": ("flash_attention_bwd", "rmsnorm_bwd", "moe_gating_bwd"),
        "hymba": ("flash_attention_bwd", "rmsnorm_bwd"),
    }
    runs = [
        ("glm4", dataclasses.replace(GLM, n_layers=1, vocab_size=512), 2, 64,
         "train glm4 card vs CPU (T3: 1 layer at full width, vocab 512)"),
        ("orloj_gpt", GPT, 2, 64, "train orloj_gpt card vs CPU (T3: full width)"),
        ("arctic", get_config("arctic_480b").reduced(n_experts=16), 2, 96,
         "train arctic card vs CPU (T4: reduced, 16 experts)"),
        ("hymba", get_config("hymba_1_5b").reduced(), 2, 96,
         "train hymba card vs CPU (T4: reduced, window 64 < S 96)"),
    ]
    windows = []
    for key, cfg, rows, seq, label in runs:
        counts = _train_step_pair(cfg, label, rows, seq)
        for name in need[key]:
            if counts[name] <= 0:
                raise SystemExit(f"{label}: no {name} kernel was launched")
        windows.append(counts)
    return windows


# The dry-run phase: three (arch × shape) combinations on the 16×16
# production mesh, over a fake process group (nothing runs on the card).
DRYRUN_CASES = (("glm4_9b", "train_4k"), ("arctic_480b", "decode_32k"), ("nemotron_4_340b", "prefill_32k"))
TRAIN_PEAKS: dict[str, int] = {}  # T1's and T2's peak memory in train(), bytes
MEMORY_TOL = 0.10  # the dry-run's predicted peak against the card's


def run_dryrun() -> None:
    """Dry-run phase: ``launch.dryrun.run_one`` for each of DRYRUN_CASES on
    the 16×16 production mesh; each result row, its per-device memory and
    whether its peak fits 80 GB.  Fails if one does not lower."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import destroy_fake_world

    try:
        for arch, shape in DRYRUN_CASES:
            r = dryrun.run_one(arch, shape, False, save=False)
            log(f"dryrun: {r.row()}")
            if not r.ok:
                raise SystemExit(f"dryrun {arch} {shape} did not lower:\n{r.error}")
            mem = r.per_device_memory
            log(f"dryrun {arch} {shape} 16x16: per-device memory {mem}: peak "
                f"{mem['peak_memory_in_bytes'] / 1e9:.2f} GB, {'fits' if r.fits else 'does NOT fit'} 80 GB; "
                f"FLOPs {r.flops:.6e}, bytes {r.bytes_accessed:.6e}, collective bytes {r.collective_bytes}")
    finally:
        destroy_fake_world()


def _grads_held(label: str, plain, dist) -> dict:
    """T3's tolerances between a plain step's (loss, gradient leaves) and a
    DTensor step's: the loss and the global gradient norm to 1e-4 relative,
    every leaf to 1e-3 of its largest |g| (at least 1)."""
    import torch

    (l1, g1), (l2, g2) = plain, dist
    n1, n2 = (float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))) for gs in (g1, g2))
    err = max(((a - b).abs().max() / max(1.0, a.abs().max().item())).item() for a, b in zip(g1, g2, strict=True))
    ok = abs(l1 - l2) <= 1e-4 * abs(l1) and abs(n1 - n2) <= 1e-4 * abs(n1) and err <= 1e-3
    log(f"{label}: loss {l1:.6f} plain vs {l2:.6f} DTensor, gradient norm {n1:.6f} vs {n2:.6f}, "
        f"{len(g1)} gradient leaves max err {err:.3e} of the leaf's largest (tol 1e-3) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: the DTensor step disagrees with the plain one")
    return {"loss": (l1, l2), "grad_err": err}


def _loss_and_grads(model, params, batch):
    import torch

    from repro_torch.optim.adamw import leaves

    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True, materialize_grads=True)
    loss = loss.detach()
    return float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss), grads


def _dtensor_train_pair(cfg, label: str, rows: int, seq: int, mesh, must_launch) -> dict[str, int]:
    """One step's loss and gradients of ``cfg`` on plain tensors, then on the
    same weights as DTensors placed by ``param_specs`` on ``mesh`` (their
    shards alias the plain tensors: nothing is updated), held by
    :func:`_grads_held`.  Returns the DTensor step's launches, which must
    include ``must_launch``."""
    import numpy as np
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.models.sharding import input_batch_specs, param_specs, place
    from repro_torch.optim.adamw import leaves

    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(4))
    for t in leaves(params):
        t.requires_grad_(True)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(rows, seq))).cuda()
             for k in ("tokens", "labels")}
    loss, grads = _loss_and_grads(model, params, batch)
    plain = (loss, [g.cpu() for g in grads])
    del grads
    _release()
    dparams = place(params, mesh, param_specs(cfg, params, mesh))
    dbatch = place(batch, mesh, input_batch_specs(cfg, mesh, batch, rows))
    ops.reset_launch_counts()
    with implicit_replication():
        loss, grads = _loss_and_grads(model, dparams, dbatch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    dist = (loss, [g.full_tensor().cpu() for g in grads])
    del grads, dparams, params
    _release()
    _grads_held(f"{label}: one train step at ({rows}, {seq})", plain, dist)
    log(f"{label}: DTensor step launches { {k: v for k, v in counts.items() if v} }")
    for name in must_launch:
        if counts[name] <= 0:
            raise SystemExit(f"{label}: the DTensor step launched no {name} kernel")
    return counts


def _dtensor_decode_pair(cfg, label: str, mesh) -> dict[str, int]:
    """Decode steps of the same weights and tokens on plain tensors and on
    DTensors (parameters by ``param_specs``, the cache by ``cache_specs``),
    the logits held to 1e-4 of the largest; returns the DTensor run's
    launches (the decode kernel must be among them)."""
    import numpy as np
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.models.sharding import cache_specs, input_batch_specs, param_specs, place

    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(5))
    rows, steps = 2, 6
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, size=(rows, steps))).cuda()
    with torch.no_grad():
        cache = model.init_cache(rows, cache_len=64)
        plain = [model.decode_step(params, toks[:, i:i + 1], cache, i)[0].float() for i in range(steps)]
        dparams = place(params, mesh, param_specs(cfg, params, mesh))
        cache = model.init_cache(rows, cache_len=64)
        dcache = place(cache, mesh, cache_specs(cfg, mesh, cache, rows, seq_shard=False))
        ops.reset_launch_counts()
        got = []
        with implicit_replication():
            for i in range(steps):
                tok = {"t": toks[:, i:i + 1]}
                tok = place(tok, mesh, input_batch_specs(cfg, mesh, tok, rows))["t"]
                got.append(model.decode_step(dparams, tok, dcache, i)[0].full_tensor().float())
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    err = max(((a - b).abs().max() / a.abs().max()).item() for a, b in zip(plain, got))
    ok = err <= 1e-4
    log(f"{label}: {steps} decode steps of ({rows}, 1), DTensor vs plain logits max err {err:.3e} of the "
        f"largest (tol 1e-4) {'ok' if ok else 'FAIL'}; DTensor launches { {k: v for k, v in counts.items() if v} }")
    if not ok or counts["decode_attention"] <= 0:
        raise SystemExit(f"{label}: the DTensor decode steps disagree or launched no decode kernel")
    del params, dparams, cache, dcache
    _release()
    return counts


def run_placement() -> list[dict[str, int]]:
    """Placement on the card: the 1-device debug mesh (an NCCL group of one),
    GLM-4-9B at full width cut to GLM_TRAIN_LAYERS layers (T2's model) with
    its parameters in DTensors by ``param_specs``: one train step at (2,
    1024) and six decode steps, each against the same on plain tensors;
    then Arctic ``.reduced(n_experts=16)`` (T4's), whose step reaches the
    gates.  The DTensor runs' launches are their windows."""
    from repro_torch.configs import get_config
    from repro_torch.configs.glm4_9b import CONFIG as GLM
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh()
    log(f"placement: debug mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
        f"{mesh.device_type} (a process group of one)")
    glm = dataclasses.replace(GLM, n_layers=GLM_TRAIN_LAYERS)
    return [
        _dtensor_train_pair(glm, "placement glm4 (T2's model, DTensor)", TRAIN_T2["batch"], TRAIN_T2["seq"],
                            mesh, ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd")),
        _dtensor_decode_pair(glm, "placement glm4 decode (DTensor)", mesh),
        _dtensor_train_pair(get_config("arctic_480b").reduced(n_experts=16), "placement arctic (T4's, DTensor)",
                            2, 96, mesh, ("moe_gating", "moe_gating_bwd", "flash_attention_bwd")),
    ]


def _train_step_peak(cfg, rows: int, seq: int) -> int:
    """The card's peak bytes over one ``make_train_step`` step of ``cfg`` at
    (rows, seq), counted from what was allocated before its parameters:
    the parameters, the AdamW moments and the batch, then the step."""
    import numpy as np
    import torch

    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import leaves

    _release()
    base = torch.cuda.memory_allocated()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for t in leaves(params):
        t.requires_grad_(True)
    opt = adamw_init(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(rows, seq))).cuda()
             for k in ("tokens", "labels")}
    torch.cuda.reset_peak_memory_stats()
    make_train_step(model, AdamWConfig())(params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del model, params, opt, batch
    _release()
    return peak


def run_memory_prediction() -> None:
    """The dry-run's memory against the card's: on the 1-device debug mesh,
    the dry-run's predicted peak of one train step of T1 (orloj_gpt at (8,
    256)) and T2 (GLM-4-9B cut to GLM_TRAIN_LAYERS layers at (2, 1024))
    against the peak of the same step on the card, held to MEMORY_TOL.
    What the fake implementations do not allocate (the flash backward's
    (2, B, H, S) float32 row statistics and its split group's dK/dV
    partials, the RMSNorm backward's per-block partials, cuBLAS's
    workspace) is in the card's peak only."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import InputShape
    from repro_torch.configs.glm4_9b import CONFIG as GLM
    from repro_torch.configs.orloj_gpt import CONFIG as GPT
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh()
    try:
        for label, cfg, t in (("T1", GPT, TRAIN_T1), ("T2", dataclasses.replace(GLM, n_layers=GLM_TRAIN_LAYERS),
                                                         TRAIN_T2)):
            res, _ = dryrun.dry_run(cfg, InputShape(label, "train", t["seq"], t["batch"]), mesh)
            if not res.ok:
                raise SystemExit(f"memory {label}: the dry-run failed:\n{res.error}")
            predicted = res.per_device_memory["peak_memory_in_bytes"]
            measured = _train_step_peak(cfg, t["batch"], t["seq"])
            rel = (predicted - measured) / measured
            ok = abs(rel) <= MEMORY_TOL
            log(f"memory {label}: {cfg.name} at ({t['batch']}, {t['seq']}): dry-run peak {predicted} bytes "
                f"({predicted / 2**30:.3f} GiB; arguments {res.per_device_memory['argument_size_in_bytes']}, "
                f"temporaries {res.per_device_memory['temp_size_in_bytes']}) against the card's "
                f"max_memory_allocated over the same step {measured} bytes ({measured / 2**30:.3f} GiB): "
                f"{rel:+.4f} (tol ±{MEMORY_TOL}) {'ok' if ok else 'FAIL'}; the train() run's peak "
                f"{TRAIN_PEAKS.get(label)} bytes")
            if not ok:
                raise SystemExit(f"memory {label}: the dry-run's peak is off the card's by {rel:+.4f}")
    finally:
        dist.destroy_process_group()


def run_op_dispatch() -> None:
    """The host's cost of a kernel call through its ``torch.library``
    operator against the raw ctypes launcher it wraps: the four forwards at
    small shapes, 500 calls in a row each way (the host's clock over the
    calls alone, then a synchronise), in turns, best of 5."""
    import torch

    from repro_torch.kernels import decode_attention as dec_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import moe_gating as gating_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms_mod

    g = torch.Generator(device="cuda").manual_seed(9)
    q, k = (torch.randn((1, 2, 32, 64), generator=g, device="cuda") for _ in range(2))
    qd, vl = q[:, :, 0].contiguous(), torch.full((1,), 32, dtype=torch.int32, device="cuda")
    x, w = torch.randn((8, 768), generator=g, device="cuda"), torch.ones(768, device="cuda")
    logits = torch.randn((16, 128), generator=g, device="cuda")
    qw, kw = (torch.randn((1, 2, 64, 64), generator=g, device="cuda") for _ in range(2))
    pairs = {
        "flash_attention": (lambda: ops.flash_attention(q, k, k), lambda: fa_mod.flash_attention_cuda(q, k, k)),
        "flash_attention (1,2,64,64), wgmma route": (lambda: ops.flash_attention(qw, kw, kw),
                                                     lambda: fa_mod.flash_attention_cuda(qw, kw, kw)),
        "decode_attention": (lambda: ops.decode_attention(qd, k, k, vl),
                             lambda: dec_mod.decode_attention_cuda(qd, k, k, vl)),
        "rmsnorm": (lambda: ops.rmsnorm(x, w), lambda: rms_mod.rmsnorm_cuda(x, w)),
        "moe_gating": (lambda: ops.moe_gating(logits, 2), lambda: gating_mod.moe_gating_cuda(logits, 2)),
    }

    def per_call(fn, n=500) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6

    with torch.no_grad():
        for name, (op, raw) in pairs.items():
            op(), raw()
            best = {"op": math.inf, "raw": math.inf}
            for _ in range(5):
                best["op"] = min(best["op"], per_call(op))
                best["raw"] = min(best["raw"], per_call(raw))
            log(f"op dispatch {name}: {best['op']:.2f} us a call through the operator, {best['raw']:.2f} us "
                f"through the raw launcher: {best['op'] - best['raw']:+.2f} us a call (host clock, best of 5 × "
                f"500 calls)")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on the card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import EngineConfig

    # Full float32 in the plain versions and the model's matrix products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    line = timed("card", phase_card)
    timed("build", phase_build)
    errs = timed("kernels vs plain", phase_kernels_vs_plain)
    errs.update(timed("backward vs plain", phase_backward_vs_plain))
    gemm_entry = timed("gemm", phase_gemm)

    ecfg = EngineConfig()
    windows = (timed("orloj_gpt", run_orloj_gpt, ecfg) + timed("arctic", run_arctic, ecfg)
               + timed("glm4", run_glm4) + timed("nemotron", run_nemotron)
               + timed("hymba", run_hymba, ecfg) + timed("xlstm", run_xlstm, ecfg)
               + timed("internvl2", run_internvl2) + timed("musicgen", run_musicgen)
               + timed("engine-smoke", run_engine_smoke)
               + timed("train orloj_gpt", run_train_orloj_gpt) + timed("train glm4", run_train_glm4)
               + timed("train card vs CPU", run_train_card_vs_cpu))
    timed("dryrun", run_dryrun)
    windows += timed("placement", run_placement)
    timed("memory", run_memory_prediction)
    timed("op dispatch", run_op_dispatch)
    counts = {name: sum(w.get(name, 0) for w in windows) for name in _build.KERNELS}

    kernels = timed("kernel line", phase_kernel_line, counts, errs)
    kernels["kernels"].append({**gemm_entry, "launches": counts["gemm"]})
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    log(line)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
