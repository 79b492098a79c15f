#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the Orloj serving path on one NVIDIA GPU.

    python3 chip_smoke.py        (from the root of a checkout; needs one card)

Phases, each reported on its own lines; any failure exits non-zero:

1. card: the GPU's name and power limit (``nvidia-smi``), the torch, CUDA
   and nvcc versions;
2. build: both attention kernels built from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a;
3. kernels vs plain: each CUDA kernel against its plain PyTorch version on
   the card (float32 tolerance 1e-4: another order of summation; bfloat16
   2e-2: one bf16 rounding of the probabilities);
4. serve: full-width ``orloj_gpt`` (12 layers, d 768, 12 heads, vocab
   32000, weights from a seeded ``torch.Generator``) profiled for Eq. 3 and
   serving 100 requests under the Orloj scheduler; the logits of a small
   batch are held against the same model run on the CPU;
5. tokens: 32 token requests through continuous batching on the decode
   kernel;
6. where the time goes: ``torch.profiler`` over one full prefill batch and
   one decode step;
7. the ``kernels`` line (JSON): launches on the main path, kernel, plain
   and library times, and the least time the card could take.

The launch counters are set to 0 just before the serve and token paths
and read just after; comparisons and timings run outside those windows.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# FLOP/s outside the tensor cores (the kernels compute in float32 on the
# SIMT cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
F32_TOL, BF16_TOL = 1e-4, 2e-2
LOGITS_TOL = 1e-3  # card vs CPU, 12 float32 layers and a 768-wide head
N_REQUESTS, N_TOKEN_REQUESTS = 100, 32


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


def flash_bound(q, k, lengths, causal: bool, window: int) -> tuple[float, str]:
    """Least time (ms) for flash attention on these inputs: q, k, v read
    once and the output written once, and 4·hd FLOPs for each (query, key)
    pair the masks let through (q·k and p·v)."""
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
    return _bound(nbytes, 4 * hd * pairs)


def decode_bound(q, k_cache, valid_len) -> tuple[float, str]:
    """Least time (ms) for decode attention on these inputs: q and the
    output once, the valid part of the K/V cache once, and 4·hd FLOPs per
    (query head, valid key)."""
    b, h, hd = q.shape
    kv = k_cache.shape[1]
    valid = int(valid_len.clamp(0, k_cache.shape[2]).sum())
    elt = q.element_size()
    nbytes = elt * (2 * b * h * hd + 2 * valid * kv * hd) + 4 * b
    return _bound(nbytes, 4 * hd * valid * h)


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    regs = {
        n: sorted({ln.split("Used ")[1].split(",")[0] for ln in out.splitlines() if "Used " in ln})
        for n, out in logs.items()
    }
    log(f"build: {', '.join(logs)} with nvcc for sm_90a in {secs:.2f} s; registers {regs}")


def _randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_kernels_vs_plain() -> dict[str, float]:
    """Every case of both kernels against its plain version; returns the
    error at each kernel's main-path shape."""
    import torch

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    main_err: dict[str, float] = {}
    failures = []

    flash_cases = [
        ("main path (8,12,256,64) f32 causal", 8, 12, 12, 256, f32, None, 0),
        ("GQA (2,8->2,256,64) f32", 2, 8, 2, 256, f32, None, 0),
        ("bf16 (8,12,256,64)", 8, 12, 12, 256, bf16, None, 0),
        ("ragged S=300 (2,12,300,64) f32", 2, 12, 12, 300, f32, None, 0),
        ("lengths [256,70,17,1,200,128,64,33] f32", 8, 12, 12, 256, f32,
         [256, 70, 17, 1, 200, 128, 64, 33], 0),
        ("window 64 (2,12,256,64) f32", 2, 12, 12, 256, f32, None, 64),
    ]
    for name, b, h, kv, s, dt, lens, window in flash_cases:
        q = _randn(gen, (b, h, s, 64), dt)
        k = _randn(gen, (b, kv, s, 64), dt)
        v = _randn(gen, (b, kv, s, 64), dt)
        lt = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = fa.flash_attention_cuda(q, k, v, lt, causal=True, window=window)
        want = ref.flash_attention_ref(q, k, v, lengths=lt, causal=True, window=window)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dt == bf16 else F32_TOL
        ok = math.isfinite(err) and err <= tol and out.dtype == dt
        log(f"kernel vs plain: flash_attention {name}: max_abs_err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention {name}")
        if name.startswith("main path"):
            main_err["flash_attention"] = err

    decode_cases = [
        ("main path (8,12,256,64) f32", 256, None),
        ("S=300 f32", 300, None),
        ("valid_len 0 rows [0,77,0,256,5,0,1,128] f32", 256, [0, 77, 0, 256, 5, 0, 1, 128]),
    ]
    for name, s, valid in decode_cases:
        q = _randn(gen, (8, 12, 64), f32)
        kc = _randn(gen, (8, 12, s, 64), f32)
        vc = _randn(gen, (8, 12, s, 64), f32)
        if valid is None:
            vl = torch.randint(1, s + 1, (8,), generator=gen, device="cuda", dtype=torch.int32)
        else:
            vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
        out = dec.decode_attention_cuda(q, kc, vc, vl)
        want = ref.decode_attention_ref(q, kc, vc, vl)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        ok = math.isfinite(err) and err <= F32_TOL and bool((out[vl == 0] == 0).all())
        log(f"kernel vs plain: decode_attention {name}: max_abs_err {err:.3e} (tol {F32_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"decode_attention {name}")
        if name.startswith("main path"):
            main_err["decode_attention"] = err
    if failures:
        raise SystemExit(f"kernels disagree with their plain versions: {failures}")
    return main_err


def phase_serve(engine, ecfg) -> dict[str, int]:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import length_sampler, make_scheduler
    from repro_torch.models import Model

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lm = engine.profile_latency_model()
    log(f"serve: Eq.3 fit on the card: c0={lm.c0:.4f} ms, c1={lm.c1 * 1e3:.5f} ms/ktok "
        f"({time.perf_counter() - t0:.1f} s to profile {len(ecfg.buckets) * len(ecfg.batch_sizes)} shapes)")
    reqs, hist = engine.make_requests(
        N_REQUESTS, lm, length_sampler=length_sampler, slo_scale=3.0, utilization=0.7, seed=0
    )
    res = engine.serve(reqs, make_scheduler("orloj", lm, hist, ecfg.batch_sizes))
    counts = ops.launch_counts()
    log(f"serve: orloj {res.summary()} n_total={res.n_total} conserved={res.conserved} "
        f"batches={res.n_batches} launches={counts}")
    if res.n_total != N_REQUESTS or not res.conserved:
        raise SystemExit(f"serve: {res.n_total} of {N_REQUESTS} requests accounted, conserved={res.conserved}")
    if counts["flash_attention"] <= 0:
        raise SystemExit("serve: the prefill path launched no flash_attention kernel")

    # What comes out is right: finite logits of the expected shape that agree
    # with the same weights run through the plain path on the CPU.
    tokens = torch.from_numpy(np.random.default_rng(0).integers(1, 1000, size=(2, 32)))
    with torch.no_grad():
        got = engine.model.logits(engine.params, {"tokens": tokens.to(engine.device)})
        cpu_params = _to_cpu(engine.params)
        want = Model(engine.model.cfg, device="cpu").logits(cpu_params, {"tokens": tokens})
    err = (got.cpu() - want).abs().max().item()
    ok = got.shape == (2, tokens.shape[1], engine.model.cfg.vocab_size) and bool(torch.isfinite(got).all())
    log(f"serve: logits {tuple(got.shape)} finite={ok}; card vs CPU max_abs_err {err:.3e} (tol {LOGITS_TOL})")
    if not ok or not err <= LOGITS_TOL:
        raise SystemExit("serve: the model's logits on the card disagree with the CPU's")
    return counts


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def phase_tokens(engine) -> dict[str, int]:
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
    log(f"tokens: token_orloj {res.summary()} tokens {done}/{want} step {step_ms:.4f} ms "
        f"(full batch 8, cache 256) launches={counts}")
    if res.n_total != N_TOKEN_REQUESTS or not res.conserved:
        raise SystemExit("tokens: requests not conserved")
    if any(r.tokens_done != r.out_tokens for r in reqs):
        raise SystemExit(f"tokens: {done} of {want} tokens served")
    if counts["decode_attention"] <= 0:
        raise SystemExit("tokens: the decode path launched no decode_attention kernel")
    return counts


def phase_where_time_goes(engine) -> None:
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
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
                if e.device_time_total > 0 and e.device_type.name == "CUDA"]
        busy = sum(t for _, t in rows)
        top = sorted(rows, key=lambda r: -r[1])[:6]
        share = ", ".join(f"{k[:48]} {t:.4f} ms" for k, t in top)
        if busy == 0:
            log(f"where the time goes: {name}: the profiler recorded no device time; wall {wall_ms:.4f} ms")
        else:
            log(f"where the time goes: {name}: wall {wall_ms:.4f} ms, device busy {busy:.4f} ms "
                f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}); top: {share}")


def phase_kernel_line(counts: dict[str, int], errs: dict[str, float]) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, s, hd = 8, 12, 256, 64
    q, k, v = (_randn(gen, (b, h, s, hd), torch.float32) for _ in range(3))
    f_bound, f_by = flash_bound(q, k, None, True, 0)
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": counts["flash_attention"], "max_abs_err": errs["flash_attention"],
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v)),
        "bound_ms": f_bound, "bound_by": f_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
    }

    qd = _randn(gen, (b, h, hd), torch.float32)
    kc, vc = (_randn(gen, (b, h, s, hd), torch.float32) for _ in range(2))
    vl = torch.full((b,), s, dtype=torch.int32, device="cuda")  # the step at full capacity
    mask = (torch.arange(s, device="cuda")[None] < vl[:, None])[:, None, None, :]
    d_bound, d_by = decode_bound(qd, kc, vl)
    decode = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:80",
        "launches": counts["decode_attention"], "max_abs_err": errs["decode_attention"],
        "ms": time_ms(lambda: dec.decode_attention_cuda(qd, kc, vc, vl)),
        "plain_ms": time_ms(lambda: ref.decode_attention_ref(qd, kc, vc, vl)),
        "bound_ms": d_bound, "bound_by": d_by,
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qd[:, :, None], kc, vc, attn_mask=mask)
        ),
    }
    return {"kernels": [flash, decode]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on the card only", file=sys.stderr)
        return 2
    from repro_torch.configs.orloj_gpt import CONFIG
    from repro_torch.serving.engine import EngineConfig, TorchServingEngine

    # Full float32 in the plain versions and the model's matrix products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    line = phase_card()
    phase_build()
    errs = phase_kernels_vs_plain()

    ecfg = EngineConfig()
    t0 = time.perf_counter()
    engine = TorchServingEngine(CONFIG, ecfg, seed=0)
    n_params = engine.model.param_count(engine.params)
    log(f"serve: {CONFIG.name} {CONFIG.n_layers} layers, d {CONFIG.d_model}, "
        f"{n_params} params, computing in float32 (built in {time.perf_counter() - t0:.1f} s)")
    serve_counts = phase_serve(engine, ecfg)
    token_counts = phase_tokens(engine)
    counts = {k: serve_counts[k] + token_counts[k] for k in serve_counts}
    phase_where_time_goes(engine)

    kernels = phase_kernel_line(counts, errs)
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    log(line)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
