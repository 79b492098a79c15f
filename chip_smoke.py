#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the Orloj serving path on one NVIDIA GPU.

    python3 chip_smoke.py        (from the root of a checkout; needs one card)

Phases, each reported on its own lines; any failure exits non-zero:

1. card: the GPU's name and power limit (``nvidia-smi``), the torch, CUDA
   and nvcc versions;
2. build: the four kernels (flash and decode attention, RMSNorm, MoE
   gating) built from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a,
   with each kernel's registers, spills and static shared memory from
   ``-Xptxas -v``;
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
   MusicGen's group of 1, rmsnorm at Hymba's (2048, 1600);
4. orloj_gpt: full width (12 layers, d 768, 12 heads, vocab 32000, weights
   from a seeded ``torch.Generator``) profiled for Eq. 3 and serving 100
   requests under the Orloj scheduler; the logits of a small batch held
   against the same weights on the CPU; 32 token requests through
   continuous batching on the decode kernel; ``torch.profiler`` over one
   full prefill batch and one decode step;
5. arctic: Snowflake Arctic at full width (d 7168, 56 query heads on 8 KV
   heads, 128 experts top-2 beside a dense SwiGLU) cut to 1 layer, in
   float32 (56 GB of weights), through the same phases; its card-vs-CPU
   check runs a second 1-layer full-width model with 8 experts and a
   512-word vocabulary, whose weights fit the host, and also holds the
   routing ids of both runs equal;
6. glm4: GLM-4-9B at full width and full depth (40 layers, d 4096, 32
   query heads on 2 KV heads of 128, vocab 151552; 37.6 GB of float32
   weights): decode ≡ forward, the decode step's time at B 1 and 8 (cache
   256) beside the weight-read bound, its launches per step, a profile of
   one step, peak memory; then its widths cut to 1 layer and a 512-word
   vocabulary, decode steps on the card against the same weights on the
   CPU with a float32 and a bfloat16 cache;
7. nemotron: Nemotron-4-340B at full width (d 18432, 96 query heads on 8 KV
   heads of 192, vocab 256000) cut to 1 layer (51.6 GB of float32 weights;
   GLM-4-9B's are freed first): decode ≡ forward at head_dim 192;
8. hymba: Hymba-1.5B at full width and depth (32 layers, d 1600, 25 query
   heads on 5 KV heads of 64, Mamba heads of state 16, window 1024; 1.40 G
   float32 parameters): serve under Orloj with rmsnorm and flash launched,
   the token path (decode at a group of 5), decode ≡ forward over 16
   tokens, the (8, 256) prefill's peak memory and device time by class
   beside one layer's Mamba branch and its chunk scan alone; then 2 layers
   at full width: a forward of 1100 tokens against 1100 decode steps across
   the 1024-slot ring's wrap;
9. xlstm: xLSTM-1.3B at full width and depth (48 blocks, d 2048, 4 heads of
   512, one sLSTM block in 8), which launches none of the four kernels:
   decode ≡ forward, the (8, 256) forward's seconds, device operations and
   idle share, and one sLSTM cell's 256 sequential steps;
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
   window; the artifact under ``build/``, the drift report per model, and
   every flash call of one re-served cell of each model held against the
   plain version;
13. one line per kernel and shape with the kernel's ratios to SDPA, to
   their plain versions and to their bounds, then the ``kernels`` line
   (JSON): launches on the main paths, kernel, plain and library times,
   and the least time the card could take (for flash also on the tensor
   cores: ``tc_bound_ms``; for the gating also its own duration from the
   profiler, ``own_ms``, and both times at T = 8, 32, 256 and 2048,
   ``by_T``).

Phases 4 and 5 also run decode ≡ forward: a prompt of a few tokens for 2
rows through ``Model.logits`` and the same tokens one by one through
``init_cache`` (of the logits' type: float32, bfloat16 for MusicGen) and
``decode_step``, held to LOGITS_TOL; phases 6 to 11 run it for their
models.  Every kernel call of those runs, and of the forwards of phases 10
and 11, is held against its plain version on the call's own inputs as it
returns, at the phase 3 tolerances (one line per kernel and shape;
``path_calls_held`` and ``path_max_abs_err`` in the ``kernels`` line).

The launch counters are set to 0 just before each serve, token, forward
and decode ≡ forward path and each engine-smoke cell, and read just after;
the line's launches are their sums.  Every path checks that no parameter
requires grad (the kernels refuse such inputs under grad mode).  The
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
# cores, three TF32 passes per float32 product.
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
    records the profiler kept (it may drop one of a run); fails if it kept
    fewer than half."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if kernel in e.key and e.device_type.name == "CUDA"]
    n = sum(e.count for e in found)
    if not calls / 2 <= n <= calls:
        raise SystemExit(f"the profiler recorded {n} {kernel} kernels for {calls} calls")
    return sum(e.device_time_total for e in found) / n / 1e3


def flash_work(q, k, lengths, causal: bool, window: int) -> tuple[int, int]:
    """(bytes, FLOPs) of flash attention on these inputs: q, k, v read once
    and the output written once, and 4·hd FLOPs for each (query, key) pair
    the masks let through (q·k and p·v)."""
    import torch

    b, h, s, hd = q.shape
    kv = k.shape[1]
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    lens = torch.full((b,), s) if lengths is None else lengths.cpu().clamp(0, s)
    pairs = sum(int(mask[:, : int(L)].sum()) for L in lens) * h
    elt = q.element_size()
    nbytes = elt * (2 * b * h * s * hd + 2 * b * kv * s * hd) + (0 if lengths is None else 4 * b)
    return nbytes, 4 * hd * pairs


def flash_bound(q, k, lengths, causal: bool, window: int) -> tuple[float, str]:
    """Least time (ms) with the float32 work at the SIMT rate."""
    return _bound(*flash_work(q, k, lengths, causal, window))


def flash_tc_bound(q, k, lengths, causal: bool, window: int) -> tuple[float, str]:
    """Least time (ms) with the work on the tensor cores: float32 as three
    TF32 passes (the kernel's split-TF32 route), bf16 as one."""
    import torch

    nbytes, flops = flash_work(q, k, lengths, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if q.dtype == torch.float32:
        t_ops = 3 * flops / TF32_FLOP_PER_S * 1e3
    else:
        t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_bound(q, k_cache, valid_len) -> tuple[float, str]:
    """Least time (ms) for decode attention on these inputs: q and the
    output once, the valid part of the K/V cache once (in the cache's own
    type), and 4·hd FLOPs per (query head, valid key)."""
    b, h, hd = q.shape
    kv = k_cache.shape[1]
    valid = int(valid_len.clamp(0, k_cache.shape[2]).sum())
    nbytes = q.element_size() * 2 * b * h * hd + k_cache.element_size() * 2 * valid * kv * hd + 4 * b
    return _bound(nbytes, 4 * hd * valid * h)


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


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_ok(out, want, bf16_input: bool) -> tuple[float, bool]:
    """The max abs error of an attention kernel's output against its plain
    version's, and whether it is within tolerance: F32_TOL; over a bf16
    input BF16_TOL (one bf16 rounding), or, where the output is bf16 and of
    magnitude 4 or more, one bf16 step of the value (0.03125 in [4, 8)):
    two roundings of nearly equal float32 values may lie a step apart."""
    import torch

    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    if not bf16_input:
        return err, math.isfinite(err) and err <= F32_TOL
    bound = torch.full_like(diff, BF16_TOL)
    if out.dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
        bound = torch.maximum(bound, step)
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
        m = re.search(r"Function properties for .*?\d([a-z_]+_kernel)I((?:f|13__nv_bfloat16|S\d*_)+)"
                      r"((?:L[a-z]\d+E)+)", ln)
        if m:
            types: list[str] = []
            for t in re.findall(r"f|13__nv_bfloat16|S\d*_", m.group(2)):
                types.append("float" if t == "f" else "bf16" if t[0] == "1" else types[-1])
            args = [*types, *re.findall(r"L[a-z](\d+)E", m.group(3))]
            name = f"{m.group(1)}<{','.join(args)}>"
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
    """Every case of the four kernels against its plain version; returns the
    error at each kernel's main-path shape (``arctic_*``: at Arctic's)."""
    import torch

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

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
        ("internvl2 (8,14->2,256,64) f32", 8, 14, 2, 256, 64, f32, None, 0, 0.0),
        ("internvl2 prefix + tokens (2,14->2,320,64) f32", 2, 14, 2, 320, 64, f32, None, 0, 0.0),
        ("musicgen (8,32,256,64) bf16", 8, 32, 32, 256, 64, bf16, None, 0, 0.0),
    ]
    for name, b, h, kv, s, hd, dt, lens, window, cap in flash_cases:
        q = _randn(gen, (b, h, s, hd), dt)
        k = _randn(gen, (b, kv, s, hd), dt)
        v = _randn(gen, (b, kv, s, hd), dt)
        lt = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = fa.flash_attention_cuda(q, k, v, lt, causal=True, window=window, softcap=cap)
        want = ref.flash_attention_ref(q, k, v, lengths=lt, causal=True, window=window, softcap=cap)
        torch.cuda.synchronize()
        err, ok = _attention_ok(out, want, dt == bf16)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        ok = ok and out.dtype == dt
        log(f"kernel vs plain: flash_attention {name}: max_abs_err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
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
        for model, prefix in (("hymba", "hymba (8"), ("hymba_window", "hymba window 1024"),
                              ("internvl2", "internvl2 (8"), ("musicgen", "musicgen (8")):
            if name.startswith(prefix):
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
        err, ok = _attention_ok(out, want, cdt == bf16)
        tol = BF16_TOL if cdt == bf16 else F32_TOL
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
    if failures:
        raise SystemExit(f"kernels disagree with their plain versions: {failures}")
    return main_err


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
    return ref.moe_gating_ref(*args, **kw)


@contextlib.contextmanager
def _kernel_log():
    """Holds every call of the four kernels through ``repro_torch.kernels.ops``
    against its plain version on the same inputs as the call returns (a
    decode cache is written before the call and again only by the next
    step), and records (name, shapes, types, max_abs_err, ok, and for bf16
    attention both errors against the plain version in float32) for
    :func:`_hold_path_calls`: attention as :func:`_attention_ok`; RMSNorm
    to ROW_TOL relative and absolute; the gating's ids exactly and its
    gates to ROW_TOL.  Only the wrappers' routes are
    wrapped: the launches and their counts are the path's own; the plain
    versions launch none of the kernels."""
    import torch

    from repro_torch.kernels import ops

    seen: list = []
    wrapped = {name: getattr(ops, name) for name in ("flash_attention", "decode_attention",
                                                      "rmsnorm", "moe_gating")}

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
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
            else:
                err, ok = _attention_ok(out, want, "bfloat16" in dtypes)
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


def phase_tokens(engine, label: str) -> dict[str, int]:
    from repro_torch.core.tokensched import LengthAwareTokenScheduler, TokenSchedConfig
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    dec = engine.decode_executor(max_batch=8, max_cache=256)
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
    return counts


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


def phase_decode_step_time(model, params, label: str) -> None:
    """The decode step at B 1 and 8 with a full 256-slot float32 cache: its
    time as a caller sees it (host clock to a synchronise) and the host's
    share of it (the enqueue), the same step replayed as a CUDA graph (the
    device's time alone), its launches and a profile, beside two bounds:
    every parameter byte read once at the HBM rate, and the bytes a step
    must move (every weight but the embedding table, of which it gathers B
    rows; the cache; the logits written)."""
    import torch

    from repro_torch.kernels import ops

    cfg = model.cfg
    param_bytes = _nbytes(params)
    weight_ms = param_bytes / HBM_BYTES_PER_S * 1e3
    table = params["embed"]["table"]
    for b in (1, 8):
        cache = model.init_cache(b, 256, dtype=torch.float32)
        tokens = torch.ones((b, 1), dtype=torch.long, device=model.device)
        step_bytes = (param_bytes - (0 if cfg.tie_embeddings else _nbytes(table))
                      + b * cfg.d_model * 4 + _nbytes(cache) + b * cfg.vocab_size * 4)
        step_ms_bound = step_bytes / HBM_BYTES_PER_S * 1e3

        def step():
            with torch.no_grad():
                model.decode_step(params, tokens, cache, 255)  # every slot valid

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
        log(f"{label} decode step B {b}, cache 256 float32: median {med:.4f} ms (min {times[0]:.4f}, "
            f"max {times[-1]:.4f}, 15 steps), of which the host's enqueue median "
            f"{enqueue[len(enqueue) // 2]:.4f} ms; as a CUDA graph {device_ms:.4f} ms; weight-read bound "
            f"{weight_ms:.4f} ms ({param_bytes} parameter bytes / 3.35 TB/s), ratio {med / weight_ms:.3f} "
            f"(graph {device_ms / weight_ms:.3f}); step byte bound {step_ms_bound:.4f} ms ({step_bytes} "
            f"bytes), ratio {med / step_ms_bound:.3f} (graph {device_ms / step_ms_bound:.3f}); "
            f"launches per step {counts}")
        _profile(step, label, f"decode step ({b} rows, cache 256)")
        del cache


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


def _flash_entry(gen, b, h, kv, s, hd, dtype, window: int = 0) -> dict:
    """Flash's time, plain and SDPA times and bounds at one causal shape,
    with a sliding window when ``window > 0`` (the bounds count only the
    (query, key) pairs the window keeps; SDPA takes the same mask).
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
        mask = (j <= i) & (j > i - window)
    tc_bound, tc_by = flash_tc_bound(q, k, None, True, window)
    # The peak rate of the inputs' type: float32 outside the tensor cores, bf16 on them.
    bound, by = (tc_bound, tc_by) if dtype == torch.bfloat16 else flash_bound(q, k, None, True, window)
    e = {
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, window=window)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, window=window)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask,
                                                                    is_causal=mask is None)),
        "tc_bound_ms": tc_bound, "tc_bound_by": tc_by, "window": window,
    }
    log(f"flash ({b},{h}->{kv},{s},{hd}) {str(dtype)[6:]} window {window}, ratios in this call: "
        f"/SDPA {e['ms'] / e['library_ms']:.3f}, /plain {e['ms'] / e['plain_ms']:.3f}, "
        f"/tc_bound {e['ms'] / tc_bound:.3f} (tc_bound {tc_bound:.6f} ms, {tc_by}), "
        f"/bound {e['ms'] / bound:.3f} (bound {bound:.6f} ms, {by}); {e['ms']:.6f} ms")
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
    bound, by = decode_bound(q, k, vl)
    e = {
        "ms": time_ms(lambda: dec.decode_attention_cuda(q, k, v, vl)),
        "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, vl)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr, attn_mask=mask)),
    }
    log(f"decode ({b},{h}->{kv},{s},{hd}) q {str(q_dtype)[6:]}, cache {str(cache_dtype)[6:]}, ratios in "
        f"this call: /SDPA {e['ms'] / e['library_ms']:.3f}, /plain {e['ms'] / e['plain_ms']:.3f}, "
        f"/bound {e['ms'] / bound:.3f} (bound {bound:.6f} ms, {by}); {e['ms']:.6f} ms")
    return e


def phase_kernel_line(counts: dict[str, int], errs: dict[str, float]) -> dict:
    """One entry per kernel.  Flash and decode are timed at orloj_gpt's
    (8,12,256,64) as before, under ``arctic`` at Arctic's (8,56->8,256,128),
    under ``glm4`` at GLM-4's (8,32->2,256,128), under ``toy`` at the
    engine-smoke toy's largest batch (4,4,32,16) and under ``nemotron`` at
    Nemotron-4-340B's (8,96->8,256,192); RMSNorm at Arctic's (2048, 7168) and the gating at
    its (2048, 128) with k 2, and also at T = 8, 32 and 256 (``by_T``)."""
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
    }

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
    entries = [flash, decode, rmsnorm, moe_gating]
    for e in entries:  # the decode ≡ forward paths' own calls, held against the plain versions
        e["path_calls_held"], e["path_max_abs_err"] = PATH_HELD.get(e["name"], (0, None))
    return {"kernels": entries}


def _release() -> None:
    """Return the memory of what the caller has just deleted to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


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
    """Device ms of a profile's operations by class: the flash and rmsnorm
    kernels, cuBLAS/CUTLASS GEMMs, and everything else."""
    out = {"gemm": 0.0, "flash_attention": 0.0, "rmsnorm": 0.0, "other": 0.0}
    for e in events:
        cls = next((k for k in ("flash_attention", "rmsnorm") if f"{k}_kernel" in e.key), None)
        if cls is None:
            cls = "gemm" if any(n in e.key for n in GEMM_NAMES) else "other"
        out[cls] += e.device_time_total / 1e3
    return out


def phase_hymba_prefill(engine) -> None:
    """Where Hymba's (8, 256) prefill spends the card's time: the profile by
    class (GEMMs, flash, rmsnorm, the rest), one layer's Mamba branch alone
    and its chunk scan alone (the forward runs 32 of each), and the
    prefill's peak memory above the weights."""
    import numpy as np
    import torch

    from repro_torch.models import ssm

    cfg = engine.model.cfg
    tokens = np.ones((8, 256), np.int32)
    engine.executor._run(tokens)  # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms, _ = engine.executor._run(tokens)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"hymba prefill (8,256): {ms:.4f} ms on the host's clock; peak {peak} bytes above the "
        f"{base} bytes held before it")
    classes = _by_class(_profile(lambda: engine.executor._run(tokens), "hymba", "prefill (8,256)"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    h = _randn(gen, (8, 256, cfg.d_model), torch.float32)
    mp = engine.params["blocks"][0]["mamba"]
    with torch.no_grad():
        branch = sum(e.device_time_total for e in _profile(
            lambda: ssm.mamba_apply(mp, h, cfg.mlstm_chunk), "hymba",
            f"one layer's Mamba branch (8,256,{cfg.d_model})"))
        a = torch.rand((8, 256, cfg.d_model, cfg.ssm_state), generator=gen, device="cuda")
        b = _randn(gen, (8, 256, cfg.d_model, cfg.ssm_state), torch.float32)
        h0 = torch.zeros((8, cfg.d_model, cfg.ssm_state), device="cuda")
        scan = sum(e.device_time_total for e in _profile(
            lambda: ssm._mamba_scan(a, b, h0, cfg.mlstm_chunk), "hymba",
            f"one layer's chunk scan (8,256,{cfg.d_model},{cfg.ssm_state})"))
    del a, b, h, h0
    log(f"hymba where the time goes: prefill (8,256) device ms by class: "
        + ", ".join(f"{k} {v:.4f}" for k, v in classes.items())
        + f"; one layer's Mamba branch {branch / 1e3:.4f} ms (x{cfg.n_layers} = "
        f"{cfg.n_layers * branch / 1e3:.4f}), of which its chunk scan {scan / 1e3:.4f} ms "
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
    windows = [phase_serve(engine, ecfg, "hymba", ("rmsnorm", "flash_attention"))]
    log(f"hymba: peak {torch.cuda.max_memory_allocated()} bytes after serving")
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


def run_xlstm() -> list[dict[str, int]]:
    """The recurrent model: xLSTM-1.3B at full width and depth (48 blocks, d
    2048, 4 heads of 512, every 8th block an sLSTM), which launches none of
    the four kernels: decode ≡ forward, and the (8, 256) forward's seconds,
    device operations and idle share, beside one sLSTM block's."""
    import torch

    from repro_torch.configs.xlstm_1_3b import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ssm

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
        f"(built in {time.perf_counter() - t0:.1f} s); it launches none of the four kernels")
    windows = [phase_decode_matches_forward(model, params, "xlstm", must_launch=())]
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
    also builds and profiles its engine).  Then one cell of each model is
    served again with every flash call recorded and held against the plain
    version; those runs are outside the windows.  Writes the artifact under
    build/ and prints the drift report per model."""
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
        # Every flash call of one cell, on its own inputs, against the plain version.
        with _kernel_log() as calls:
            runner.run_specs([cells[0]], jobs=1)
        flash_calls = [c for c in calls if c[0] == "flash_attention"]
        if not flash_calls:
            raise SystemExit(f"engine-smoke {model}: the held run made no flash call")
        _hold_path_calls(flash_calls, f"engine-smoke {model} {cells[0].tag} (served again)")
        del calls, flash_calls
        if model == "orloj_gpt":
            big = max(engine.cfg.batch_sizes), max(engine.cfg.buckets)
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

    ecfg = EngineConfig()
    windows = (timed("orloj_gpt", run_orloj_gpt, ecfg) + timed("arctic", run_arctic, ecfg)
               + timed("glm4", run_glm4) + timed("nemotron", run_nemotron)
               + timed("hymba", run_hymba, ecfg) + timed("xlstm", run_xlstm)
               + timed("internvl2", run_internvl2) + timed("musicgen", run_musicgen)
               + timed("engine-smoke", run_engine_smoke))
    counts = {name: sum(w[name] for w in windows) for name in _build.KERNELS}

    kernels = timed("kernel line", phase_kernel_line, counts, errs)
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    log(line)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
