#!/usr/bin/env python3
"""PERF.md §6's kernel table, measured on one card, and the timing helpers
of the other kernel scripts.

    python3 scripts/kernel_table.py [--steps] [--out build/kernel_table.json]

Builds the nine kernels with nvcc and prints each kernel instantiation's
registers, spills and static shared memory (``ptxas:`` lines; a library
built before is compiled once more aside for its report).  Then one line a
row of the table, each kernel at its row's shape:

- 1: the flash forward at (8,12,256,64) float32, causal, and at the shapes
  queue P of ROADMAP.md cites (GLM-4-9B's group of 16, InternVL2's of 7,
  Hymba-1.5B's window, Granite's group of 48, MusicGen's bf16 heads);
- 1b: its backward at (8,12,256,64) float32, in bf16 and at GLM-4-9B's
  training shape (2,32->2,1024,128), with the split count and each
  launch's own duration;
- 2: decode attention at (8,12,256,64) float32, every slot valid, and at
  GLM-4-9B's bf16 cache of 4,096 slots, Nemotron-4-340B's group of 12,
  DBRX's of 6 and Granite's of 48;
- 3, 3b: RMSNorm at (2048, 7168) and its backward at (2048, 4096), float32;
- 4, 4b: the MoE gates at (2048, 128) k 2 and their backward;
- 5: the float32 GEMM at GLM-4-9B's gate, (128,4096)x(4096,13696);
- 6: the selective scan at Hymba-1.5B's (4, 2176, 3200) and (1, 2176, 3200).

Each line gives the kernel's time by graph replay (``time_ms``), where
the table has one its own duration from the profiler (``own_ms``), its
bound (the larger of its bytes at 3.35 TB/s and its operations at the rate
its route runs them), the plain version's time and the library's.  A row's
launches are those of one captured graph (``_Program.launches``): a
GLM-4-9B forward for flash, RMSNorm and the GEMM, the token path's decode
step at its widths (one attention call a step) for decode attention, a
Hymba-1.5B forward for the scan, a reduced Arctic
forward for the gates, and a reduced GLM-4-9B's and Arctic's train step
for the backwards.

``--steps`` also prints the step timings queue P cites: GLM-4-9B's decode
step at B 1 and 8 (P4), the training steps T1 and T2 (P7, P12), and
xLSTM-1.3B's forward and one sLSTM cell's 256 steps beside a 1-layer
Arctic forward at full width (P8, P10).  The flag selects what is printed,
not how the kernels run.  Writes every reading to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# Published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32
# FLOP/s outside the tensor cores, and the dense tensor-core rates in TF32
# and bf16.  A float32 product on the tensor cores is three TF32 passes.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def release() -> None:
    """Return the memory of what the caller has just deleted to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ timing
def time_ms(fn, reps: int | None = 20, graphs: int = 5, budget_ms: float = 30.0) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``graphs`` times between CUDA events (``reps=None``: as many
    as fill about ``budget_ms``, from one call timed first).  The graph
    removes the host's launch cost, so the number is the card's."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if reps is None:
        fn()
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        reps = max(3, min(200, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
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
    start.record()
    for _ in range(graphs):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * graphs)


def own_ms(fn, kernel: str, calls: int = 20) -> float:
    """Mean device duration (ms) of the kernel whose name holds ``kernel``,
    over ``calls`` calls of ``fn``, from the profiler's CUPTI kernel
    records: the kernel's own run, without the launch interval that
    :func:`time_ms` also holds."""
    return own_ms_each(fn, (kernel,), calls)[kernel]


def own_ms_each(fn, kernels, calls: int = 20) -> dict[str, float]:
    """:func:`own_ms` of each kernel of ``kernels`` (each launched once a
    call of ``fn``), from one profile.  A warm-up step, whose records are
    discarded, comes before the measured one: a profile that starts cold
    may keep only 6 to 9 records of 20.  The mean is over the records kept
    (the profiler may drop one of a run); fails if fewer than half are."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
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
    times a kernel: ``forward(*ins)`` once on a side stream, then 20 calls
    of ``torch.autograd.grad`` of its output for ``dout`` captured in a
    CUDA graph on that stream and replayed 5 times between CUDA events."""
    import torch

    reps, graphs = 20, 5
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = forward(*ins)
        for _ in range(3):
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


def profiled(fn) -> dict:
    """One call of ``fn`` under the profiler: wall ms (host clock to a
    synchronise), device busy ms, idle share and the eight operations that
    took most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy = sum(t for _, t in rows)
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "top": [[k[:60], t] for k, t in sorted(rows, key=lambda r: -r[1])[:8]]}


# ------------------------------------------------------------ bounds
def _bound(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the FLOPs' at
    ``flop_per_s``, in ms, and which it was."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(q, k, lengths, causal: bool, window: int) -> tuple[float, str]:
    """Least time (ms) of flash attention with its float32 work at the SIMT
    rate (``orloj_bench.work.flash_work``'s bytes and FLOPs)."""
    from orloj_bench.work import flash_work

    return _bound(*flash_work(q, k, lengths, causal, window))


def flash_tc_bound(q, k, lengths, causal: bool, window: int) -> tuple[float, str]:
    """Least time (ms) with the work on the tensor cores: float32 as three
    TF32 passes (the kernel's split-TF32 route), bf16 as one."""
    import torch

    from orloj_bench.work import flash_work

    nbytes, flops = flash_work(q, k, lengths, causal, window)
    if q.dtype == torch.float32:
        return _bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    return _bound(nbytes, flops, BF16_FLOP_PER_S)


def flash_bwd_bound(q, k, causal: bool, window: int) -> tuple[float, str]:
    """Least time (ms) of the flash backward: q, k, v, the output, its
    gradient and the float32 LSE read once, dq, dk, dv written once; five
    products of hd multiply-adds a (query, key) pair the masks let through,
    on the tensor cores (float32 as three TF32 passes)."""
    import torch

    from orloj_bench.work import flash_work

    b, h, s, hd = q.shape
    pairs = flash_work(q, k, None, causal, window)[1] // (4 * hd)
    nbytes = q.element_size() * (4 * b * h * s * hd + 4 * b * k.shape[1] * s * hd) + 4 * b * h * s
    if q.dtype == torch.float32:
        return _bound(nbytes, 3 * 10 * hd * pairs, TF32_FLOP_PER_S)
    return _bound(nbytes, 10 * hd * pairs, BF16_FLOP_PER_S)


def decode_bound(q, k_cache, valid_len, route: str) -> tuple[float, str]:
    """Least time (ms) of decode attention: q and the output once, the valid
    part of the cache once (in its own type), 4·hd FLOPs a (query head,
    valid key), at the rate of the kernel's ``route`` (``decode_plan``'s):
    SIMT and head size 512 at the float32 SIMT rate; the tensor cores over
    a float32 cache as three TF32 passes, over a bf16 cache as bf16
    products, one for each bf16 part of the queries' type."""
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


def rmsnorm_bound(x) -> tuple[float, str]:
    """x read and the output written once, the float32 scale once; ~4 FLOPs
    an element."""
    t, d = x.shape
    return _bound(2 * t * d * x.element_size() + 4 * d, 4 * t * d)


def rmsnorm_bwd_bound(x) -> tuple[float, str]:
    """x and dy read, dx written, the scale read and dscale written once;
    ~10 FLOPs an element."""
    t, d = x.shape
    return _bound(3 * t * d * x.element_size() + 8 * d, 10 * t * d)


def gating_bound(logits, k: int) -> tuple[float, str]:
    """The float32 logits read once, the (T, k) gates and ids written once;
    a subtraction, an exp, a division and k comparisons a logit."""
    t, e = logits.shape
    return _bound(4 * t * e + 8 * t * k, (3 + k) * t * e)


def gating_bwd_bound(logits, k: int) -> tuple[float, str]:
    """The logits read and their gradient written once, the (T, k) ids and
    gate gradients read once; ~6 FLOPs a logit."""
    t, e = logits.shape
    return _bound(2 * logits.element_size() * t * e + 8 * t * k, 6 * t * e)


def scan_bound(x, n_state: int) -> tuple[float, str]:
    """A selective scan over x (B, S, E): x, Δ and the gate's input read
    once, B and C ((B, S, N) each) read once and y written once."""
    b, s, e = x.shape
    return _bound(x.element_size() * (4 * b * s * e + 2 * b * s * n_state), 0.0)


def weight_bytes_bound_s(n: int, k: int) -> float:
    """The least time the card takes to read a (k, n) float32 weight once."""
    return 4 * k * n / HBM_BYTES_PER_S


def work_bound_s(m: int, n: int, k: int) -> float:
    """The least time of a float32 product's work through three TF32 passes
    (165 TFLOP/s)."""
    from repro_torch.kernels import gemm

    return gemm.flops(m, n, k) / (TF32_FLOP_PER_S / 3)


def gemm_bound_s(m: int, n: int, k: int) -> tuple[float, str]:
    """The GEMM kernel's bound on its route, and which of the two sets it."""
    b, w = weight_bytes_bound_s(n, k), work_bound_s(m, n, k)
    return (b, "bytes") if b >= w else (w, "operations")


# ------------------------------------------------------------ the build
def ptxas_report(out: str) -> list[tuple[str, str]]:
    """(kernel<template arguments>, registers, spills and static shared
    memory) for each entry function in an ``-Xptxas -v`` log."""
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


def build() -> dict[str, list]:
    """Every kernel built (in parallel), and each one's ptxas report."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {', '.join(logs)} with nvcc for sm_90a in {time.perf_counter() - t0:.2f} s", flush=True)
    report = {}
    for name, out in logs.items():
        if not out:  # built before: compiled once more aside for the report
            with tempfile.TemporaryDirectory() as tmp:
                out = subprocess.run(_build.nvcc_command(name, Path(tmp) / "lib.so"), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True, check=True).stdout
        report[name] = ptxas_report(out)
        for fn, props in report[name]:
            print(f"ptxas: {fn}: {props}", flush=True)
    return report


# ------------------------------------------------------------ launches
def graph_launches() -> dict[str, tuple[str, int]]:
    """Each kernel's launches in one captured graph of the path that runs
    it: (the graph, the count)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainProgram
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import leaves
    from repro_torch.serving.engine import DecodeTorchExecutor, EngineConfig, TorchExecutor

    def served(cfg, shape):
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        ex = TorchExecutor(model, params, EngineConfig(buckets=(shape[1],), batch_sizes=(shape[0],)))
        ex._run(np.ones(shape, np.int32))
        counts = dict(ex._shapes[shape][1].launches)
        del ex, params, model
        release()
        return counts

    def train_step(cfg):
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        for t in leaves(params):
            t.requires_grad_(True)
        state = adamw_init(params)
        program = TrainProgram(model, AdamWConfig(), params, state, (2, 64))
        batch = {k: torch.ones((2, 64), dtype=torch.long, device="cuda") for k in ("tokens", "labels")}
        program(params, state, batch)  # the eager step, then the capture
        counts = dict(program.launches)
        del program, state, params, model
        release()
        return counts

    glm, arctic = get_config("glm4_9b"), get_config("arctic_480b")
    dec = DecodeTorchExecutor(glm, max_batch=8, max_cache=256, device="cuda")
    decode = dict(dec._program.launches)
    del dec
    release()
    glm_fwd, glm_train = "GLM-4-9B forward (1, 32)", "reduced GLM-4-9B train step (2, 64)"
    dec_step, hymba_fwd = "token-path decode step at GLM-4-9B's widths (B 8, 256 slots)", "Hymba-1.5B forward (1, 256)"
    arctic_fwd, arctic_train = "reduced Arctic forward (1, 32)", "reduced Arctic train step (2, 64)"
    graphs = {glm_fwd: served(glm, (1, 32)), dec_step: decode,
              hymba_fwd: served(get_config("hymba_1_5b"), (1, 256)), arctic_fwd: served(arctic.reduced(), (1, 32)),
              glm_train: train_step(glm.reduced()), arctic_train: train_step(arctic.reduced(n_experts=16))}
    where = {"flash_attention": glm_fwd, "rmsnorm": glm_fwd, "gemm": glm_fwd, "decode_attention": dec_step,
             "selective_scan": hymba_fwd, "moe_gating": arctic_fwd, "flash_attention_bwd": glm_train,
             "rmsnorm_bwd": glm_train, "moe_gating_bwd": arctic_train}
    return {name: (graph, graphs[graph].get(name, 0)) for name, graph in where.items()}


# ------------------------------------------------------------ the rows
def _line(label: str, e: dict) -> None:
    print(f"{label}: " + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                                   for k, v in e.items()), flush=True)


def flash_rows(gen) -> list[dict]:
    """Row 1: the flash forward, causal, at the row's shape and the shapes
    queue P cites; ``bound_ms`` at the inputs' type's rate (float32: SIMT),
    ``tc_bound_ms`` on the tensor cores; the library is SDPA on the same
    mask, the keys repeated over the group."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    for b, h, kv, s, hd, dtype, window in ((8, 12, 12, 256, 64, f32, 0), (8, 32, 2, 256, 128, f32, 0),
                                           (8, 14, 2, 256, 64, f32, 0), (8, 25, 5, 256, 64, f32, 1024),
                                           (8, 48, 1, 256, 128, f32, 0), (8, 32, 32, 256, 64, bf16, 0)):
        q = randn(gen, (b, h, s, hd), dtype)
        k, v = (randn(gen, (b, kv, s, hd), dtype) for _ in range(2))
        kr, vr = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
        mask = None
        if window:
            i, j = torch.arange(s, device="cuda")[:, None], torch.arange(s, device="cuda")[None, :]
            mask = (j <= i) & (j > i - window)
        tc, tc_by = flash_tc_bound(q, k, None, True, window)
        bound, by = (tc, tc_by) if dtype == bf16 else flash_bound(q, k, None, True, window)
        plan = fa.flash_plan(b, h, kv, s, hd, dtype, window, torch.cuda.get_device_properties(0).multi_processor_count)
        e = {"shape": [b, h, kv, s, hd], "dtype": str(dtype)[6:], "window": window,
             "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, window=window)),
             "bound_ms": bound, "bound_by": by, "tc_bound_ms": tc, "tc_bound_by": tc_by,
             "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, window=window)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask,
                                                                         is_causal=mask is None)),
             "plan": f"{plan.route} {plan.warps}w {plan.heads}x{plan.positions} {plan.stages}st"}
        _line("row 1 flash_attention", e)
        rows.append(e)
    return rows


def flash_bwd_rows(gen) -> list[dict]:
    """Row 1b: the flash backward kernel (prep, dq, dK/dV and, where the GQA
    group is split, the partials' sum), autograd through the plain version
    and SDPA's backward on the same q and dO with the KV heads repeated."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = []
    for b, h, kv, s, hd, dtype in ((8, 12, 12, 256, 64, torch.float32), (8, 12, 12, 256, 64, torch.bfloat16),
                                   (2, 32, 2, 1024, 128, torch.float32)):
        q, dout = (randn(gen, (b, h, s, hd), dtype) for _ in range(2))
        k, v = (randn(gen, (b, kv, s, hd), dtype) for _ in range(2))
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
        kernel = lambda: fa.flash_attention_backward_cuda(q, k, v, out, dout, lse)  # noqa: E731
        ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        lib = [t.detach().clone().requires_grad_(True)
               for t in (q, k.repeat_interleave(h // kv, 1), v.repeat_interleave(h // kv, 1))]
        splits = fa.backward_splits(b, h, kv, s, hd, _build.sm_count(q.device))
        names = ["flash_bwd_prep_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"]
        bound, by = flash_bwd_bound(q, k, True, 0)
        e = {"shape": [b, h, kv, s, hd], "dtype": str(dtype)[6:], "ms": time_ms(kernel), "splits": splits,
             "own_ms": own_ms_each(kernel, names + (["flash_bwd_sum_kernel"] if splits > 1 else [])),
             "tc_bound_ms": bound, "tc_bound_by": by,
             "plain_ms": grad_ms(ref.flash_attention_ref, ins, dout),
             "library_ms": grad_ms(lambda *t: F.scaled_dot_product_attention(*t, is_causal=True), lib, dout)}
        _line("row 1b flash_attention_bwd", e)
        rows.append(e)
    return rows


def decode_rows(gen) -> list[dict]:
    """Row 2: decode attention over a full cache at the row's shape and the
    shapes queue P cites; the library is SDPA given the valid-slot mask."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    f32, bf16 = torch.float32, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for b, h, kv, s, hd, cdt in ((8, 12, 12, 256, 64, f32), (8, 32, 2, 4096, 128, bf16),
                                 (8, 96, 8, 256, 192, f32), (8, 48, 8, 256, 128, f32),
                                 (4, 48, 1, 4096, 128, f32)):
        q = randn(gen, (b, h, hd), f32)
        k, v = (randn(gen, (b, kv, s, hd), cdt) for _ in range(2))
        kr, vr = (t.float().repeat_interleave(h // kv, dim=1) for t in (k, v))
        vl = torch.full((b,), s, dtype=torch.int32, device="cuda")
        mask = torch.ones((b, 1, 1, s), dtype=torch.bool, device="cuda")
        plan = dec.decode_plan(b, h, kv, s, hd, f32, cdt, sms)
        bound, by = decode_bound(q, k, vl, plan.route)
        e = {"shape": [b, h, kv, s, hd], "cache": str(cdt)[6:], "route": plan.route,
             "ms": time_ms(lambda: dec.decode_attention_cuda(q, k, v, vl)), "bound_ms": bound, "bound_by": by,
             "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, vl)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr, attn_mask=mask))}
        _line("row 2 decode_attention", e)
        rows.append(e)
    return rows


def rmsnorm_rows(gen) -> list[dict]:
    """Rows 3 and 3b: RMSNorm at (2048, 7168) and its backward at (2048,
    4096), float32, beside ``F.rms_norm`` and its backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    f32 = torch.float32
    x, scale = randn(gen, (2048, 7168), f32), randn(gen, (7168,), f32)
    bound, by = rmsnorm_bound(x)
    fwd = {"ms": time_ms(lambda: rms.rmsnorm_cuda(x, scale, eps=1e-5)), "bound_ms": bound, "bound_by": by,
           "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, scale, 1e-5)),
           "library_ms": time_ms(lambda: F.rms_norm(x, (7168,), weight=scale, eps=1e-5))}
    _line("row 3 rmsnorm (2048,7168)", fwd)
    x, dy, scale = randn(gen, (2048, 4096), f32), randn(gen, (2048, 4096), f32), randn(gen, (4096,), f32)
    ins = [t.detach().clone().requires_grad_(True) for t in (x, scale)]
    kernel = lambda: rms.rmsnorm_backward_cuda(x, scale, dy, eps=1e-5)  # noqa: E731
    bound, by = rmsnorm_bwd_bound(x)
    bwd = {"ms": time_ms(kernel),
           "own_ms": own_ms_each(kernel, ("rmsnorm_bwd_rows_kernel", "rmsnorm_bwd_reduce_kernel")),
           "bound_ms": bound, "bound_by": by,
           "plain_ms": grad_ms(lambda a, w: ref.rmsnorm_ref(a, w, 1e-5), ins, dy),
           "library_ms": grad_ms(lambda a, w: F.rms_norm(a, (4096,), weight=w, eps=1e-5), ins, dy)}
    _line("row 3b rmsnorm_bwd (2048,4096)", bwd)
    return [fwd, bwd]


def gating_rows(gen) -> list[dict]:
    """Rows 4 and 4b: the gates at (2048, 128) k 2 and their backward; no
    library call does softmax, top-k and the renormalisation at once, so
    the composite of the three stands beside them."""
    import torch

    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import ref

    logits = randn(gen, (2048, 128), torch.float32) * 2

    def composite(x):
        top, ids = torch.topk(torch.softmax(x, dim=-1), 2, dim=-1)
        return top / top.sum(-1, keepdim=True).clamp_min(1e-9), ids

    bound, by = gating_bound(logits, 2)
    fwd = {"ms": time_ms(lambda: gating.moe_gating_cuda(logits, 2)),
           "own_ms": own_ms(lambda: gating.moe_gating_cuda(logits, 2), "moe_gating_kernel"),
           "bound_ms": bound, "bound_by": by, "plain_ms": time_ms(lambda: ref.moe_gating_ref(logits, 2)),
           "composite_ms": time_ms(lambda: composite(logits))}
    _line("row 4 moe_gating (2048,128) k 2", fwd)
    _, ids = gating.moe_gating_cuda(logits, 2)
    dg = randn(gen, (2048, 2), torch.float32)
    lg = [logits.detach().clone().requires_grad_(True)]
    kernel = lambda: gating.moe_gating_backward_cuda(logits, ids, dg)  # noqa: E731
    bound, by = gating_bwd_bound(logits, 2)
    bwd = {"ms": time_ms(kernel), "own_ms": own_ms(kernel, "moe_gating_bwd_kernel"),
           "bound_ms": bound, "bound_by": by, "plain_ms": grad_ms(lambda x: ref.moe_gating_ref(x, 2)[0], lg, dg),
           "composite_ms": grad_ms(lambda x: composite(x)[0], lg, dg)}
    _line("row 4b moe_gating_bwd (2048,128) k 2", bwd)
    return [fwd, bwd]


def gemm_row(gen) -> dict:
    """Row 5: the GEMM at GLM-4-9B's gate, (128,4096)x(4096,13696), beside
    ``x @ w`` (the plain version, cuBLAS) and ``torch.matmul``."""
    import math

    import torch

    from repro_torch.kernels import gemm

    m, k, n = 128, 4096, 13696
    x = randn(gen, (m, k), torch.float32)
    w = randn(gen, (k, n), torch.float32) / math.sqrt(k)
    bound, by = gemm_bound_s(m, n, k)
    own = own_ms(lambda: gemm.gemm_cuda(x, w), "gemm_kernel")
    e = {"ms": time_ms(lambda: gemm.gemm_cuda(x, w)), "own_ms": own, "tflops": gemm.flops(m, n, k) / own / 1e9,
         "bound_ms": bound * 1e3, "bound_by": by, "plain_ms": time_ms(lambda: gemm.gemm_ref(x, w)),
         "library_ms": time_ms(lambda: torch.matmul(x, w))}
    _line("row 5 gemm (128,4096)x(4096,13696)", e)
    return e


def scan_rows(gen) -> list[dict]:
    """Row 6: the selective scan at Hymba-1.5B's largest served batch (4
    rows of 128 meta tokens and the 2048 bucket, inner width 3200) and at
    one row: its kernels' own durations, the plain version's (a position
    at a time) and the torch doubling scan's."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as sc
    from repro_torch.models import ssm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for b in (4, 1):
        def n(*shape):
            return randn(gen, shape, torch.float32)

        e_, s = 3200, 2176
        dt = torch.nn.functional.softplus(n(b, s, e_) * 0.5 - 4.0)
        a_log = torch.log(torch.arange(1, 17, dtype=torch.float32, device="cuda")) + 0.1 * n(e_, 16)
        ins = (n(b, s, e_), dt, n(b, s, 16), n(b, s, 16), n(b, s, e_), a_log, 1.0 + 0.1 * n(e_))
        kernel = lambda: sc.selective_scan_cuda(*ins)  # noqa: E731
        bound, by = scan_bound(ins[0], 16)
        e = {"shape": [b, s, e_], "ms": time_ms(kernel, reps=5, graphs=3),
             "own_ms": own_ms_each(kernel, ("selective_scan_runs_kernel", "selective_scan_kernel")),
             "bound_ms": bound, "bound_by": by,
             "plain_ms": time_ms(lambda: ref.selective_scan_ref(*ins), reps=1, graphs=1),
             "torch_ms": time_ms(lambda: ssm._scan_torch(*ins, chunk=256), reps=1, graphs=1),
             "runs": sc.scan_plan(b, s, e_, sms)}
        _line("row 6 selective_scan", e)
        rows.append(e)
    return rows


# ------------------------------------------------------------ --steps
def decode_steps() -> list[dict]:
    """P4: GLM-4-9B's decode step at full depth and width at B 1 and 8 over
    a full float32 cache of 256 slots and at B 8 over its bf16 cache of
    32,768: the median of 15 eager steps on the host's clock, the step
    replayed as a CUDA graph, beside the weight-read bound and the bytes a
    step must move."""
    import statistics

    import torch

    from repro_torch.configs.glm4_9b import CONFIG
    from repro_torch.models import Model
    from repro_torch.optim.adamw import leaves

    model = Model(CONFIG, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in leaves(tree))  # noqa: E731
    param_bytes = nbytes(params)
    rows = []
    for b, slots, dtype in ((1, 256, torch.float32), (8, 256, torch.float32), (8, 32768, torch.bfloat16)):
        cache = model.init_cache(b, slots, dtype=dtype)
        tokens = torch.ones((b, 1), dtype=torch.long, device="cuda")

        def step():
            with torch.no_grad():
                model.decode_step(params, tokens, cache, slots - 1)  # every slot valid

        for _ in range(3):
            step()
        times = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_bytes = (param_bytes - nbytes(params["embed"]["table"]) + b * CONFIG.d_model * 4 + nbytes(cache)
                      + b * CONFIG.vocab_size * 4)
        e = {"rows": b, "slots": slots, "cache": str(dtype)[6:], "eager_ms": statistics.median(times),
             "graph_ms": time_ms(step, reps=3, graphs=3),
             "weight_bound_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
             "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3}
        _line("P4 GLM-4-9B decode step", e)
        rows.append(e)
        del cache
        release()
    del params, model
    release()
    return rows


def train_steps() -> list[dict]:
    """P7, P12: ``launch.train.train`` on the card (step 1 eager, then
    replays of the step's CUDA graph): T1, full-width orloj_gpt 50 steps at
    (8, 256); T2, GLM-4-9B at full width cut to 4 layers, 5 steps at (2,
    1024).  The median ms a step on the host's clock, the corpus's ms a
    batch and share of the steps, and one more replay under the profiler."""
    import statistics

    import torch

    from repro_torch.configs.glm4_9b import CONFIG as GLM
    from repro_torch.configs.orloj_gpt import CONFIG as GPT
    from repro_torch.launch.train import train

    rows = []
    for label, cfg, kw in (("T1", GPT, dict(steps=50, batch=8, seq=256)),
                           ("T2", dataclasses.replace(GLM, n_layers=4), dict(steps=5, batch=2, seq=1024))):
        torch.cuda.reset_peak_memory_stats()
        rec: dict = {}
        losses = train(cfg, device="cuda", record=rec, **kw)
        step_ms, data_ms = rec["step_ms"][1:], rec["data_ms"][1:]
        program, params, state = rec["train_step"], rec["params"], rec["opt_state"]
        batch = next(rec["iterator"])
        e = {"step": label, "loss_first": losses[0], "loss_last": losses[-1],
             "first_step_ms": rec["step_ms"][0], "step_ms": statistics.median(step_ms),
             "data_ms": statistics.median(data_ms), "data_share": sum(data_ms) / sum(step_ms),
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "replay": profiled(lambda: program(params, state, batch))}
        _line(f"{label} train step", e)
        rows.append(e)
        rec.clear()
        del program, params, state, batch
        release()
    return rows


def forward_profiles() -> list[dict]:
    """P8, P10: one profiled forward of xLSTM-1.3B at full depth and width
    at (8, 256), whose sLSTM blocks step through 256 positions one at a
    time, beside one sLSTM block's cell alone; and Snowflake Arctic at full
    width cut to one layer (56 GB of float32 weights) at (1, 32), whose
    experts run on cuBLAS."""
    import torch

    from repro_torch.configs.arctic_480b import CONFIG as ARCTIC
    from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM
    from repro_torch.models import Model, ssm

    rows = []
    for label, cfg, shape in (("xLSTM-1.3B forward", XLSTM, (8, 256)),
                              ("Arctic 1 layer forward", dataclasses.replace(ARCTIC, n_layers=1), (1, 32))):
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        tokens = torch.ones(shape, dtype=torch.long, device="cuda")

        def forward():
            with torch.no_grad():
                model.logits(params, {"tokens": tokens})

        forward()
        e = {"model": label, "shape": list(shape), **profiled(forward)}
        _line(label, e)
        rows.append(e)
        if cfg is XLSTM:
            block = next(i for i in range(cfg.n_layers) if i % cfg.slstm_every == cfg.slstm_every - 1)
            h = randn(torch.Generator(device="cuda").manual_seed(5), (*shape, cfg.d_model), torch.float32)
            with torch.no_grad():
                cell = profiled(lambda: ssm.slstm_apply(params["blocks"][block]["cell"], h, cfg.n_heads))
            e = {"model": "one sLSTM cell, 256 steps", "shape": [*shape, cfg.d_model], **cell}
            _line("xLSTM-1.3B sLSTM cell", e)
            rows.append(e)
            del h
        del params, model
        release()
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", action="store_true", help="also print the step timings queue P cites")
    ap.add_argument("--out", default="build/kernel_table.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_table: no CUDA device is visible; the table is measured on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    out = {"card": card, "device": torch.cuda.get_device_name(0), "ptxas": build()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    out["rows"] = {"1": flash_rows(gen), "1b": flash_bwd_rows(gen), "2": decode_rows(gen)}
    out["rows"]["3"], out["rows"]["3b"] = rmsnorm_rows(gen)
    out["rows"]["4"], out["rows"]["4b"] = gating_rows(gen)
    out["rows"]["5"], out["rows"]["6"] = gemm_row(gen), scan_rows(gen)
    release()
    out["launches"] = graph_launches()
    for name, (graph, n) in out["launches"].items():
        print(f"launches {name}: {n} in one {graph}", flush=True)
    if args.steps:
        out["steps"] = {"decode": decode_steps(), "train": train_steps(), "forward": forward_profiles()}
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
