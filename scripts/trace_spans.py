"""The program's span log over a benchmark cell's windows on the card: what
recording costs, and readings of every span and counter.

    python3 scripts/trace_spans.py --workload glm4_9b.bimodal.r80 --seed 7 --pairs 1 \\
        --out build/trace_spans.json

One set-up by the benchmark's own ``harness.setup`` (the seeded weights,
the engine on the cell's ``engine`` settings), with a ``SpanLog`` on the
executor through the Eq.-3 fit.  Then windows of the cell's traffic by
``harness.window`` (its ``CheckedExecutor``, the loop charging the
scheduler's decisions), ``--pairs`` times in turns without and with a span
log on the executor and the loop (off, on, on, off) and no device trace,
and last one window with a span log under the device trace.  The windows share
the seed, so they serve the same arrivals.  Prints one JSON object a window
and writes them all, with the set-up's readings and the cost of a span
timed alone, to ``--out``.

The readings of a window with a log:

- ``sched_us_per_next_batch``: ``hook_ms["next_batch"]`` over its calls,
  the scheduler time the loop's clock charges;
- ``exec_host_us_per_batch``: the window's ``exec.pad`` and ``exec.h2d``
  over its batches, the executor's host part that the clock charges and the
  Eq.-3 fit does not see;
- ``queue_wait_p95_ms``: the 95th percentile of ``loop.queue_wait_ms``;
- under the device trace, ``idle_charged``: the window's device-idle time
  under a ``sched.next_batch`` or ``exec.*`` span, over the window (%),
  beside ``device_idle`` and the idle time under each span name;
- of the set-up, ``setup_fit_s`` (``engine.fit``) and ``kernels.build``;
- of the set-up's graphs, the GEMM counter: each captured (k, bucket)
  graph's GEMM launches over the weight products its configuration's
  family lists (``gemm_products``: 281 for GLM-4-9B, 420 for
  Hymba-1.5B), as a share.

Without a card it runs on the CPU (``--device cpu``, no traced window),
where only the counts mean anything.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]


def gemm_share(cell, engine) -> dict:
    """The GEMM counter of each captured graph of the executor: its GEMM
    launches, the weight products the family lists at its shape, and the
    least share of them."""
    from orloj_bench import families

    products = families.of(cell.config).gemm_products
    by_shape = {f"{k}x{b}": (prog.launches.get("gemm", 0), len(products(cell.config, k, b)))
                for (k, b), (_, prog) in sorted(engine.executor._shapes.items()) if prog.graph is not None}
    return {"gemm_launches_and_products_by_graph": by_shape,
            "gemm_share_min": min((100.0 * n / p for n, p in by_shape.values()), default=0.0)}


def window(cell, engine, lm, seed: int, seconds: float, device, log, trace: bool):
    """``orloj_bench.harness.window`` with ``log`` (or none) on the executor
    and the loop → (run, checked executor, wall s: the window's traffic
    made, served and synchronised)."""
    from orloj_bench import harness

    engine.executor.spans = log
    t0 = time.perf_counter()
    sim, requests, exe, tr = harness.window(cell, engine, lm, seed, seconds, trace, device, spans=log)
    wall = time.perf_counter() - t0
    engine.executor.spans = None
    slo = cell.traffic["slo_ms"]
    run = harness.Run(cell=cell, sim=sim, counted=harness.count(requests, sim.makespan_ms, slo),
                      t_end_ms=sim.makespan_ms, slo_ms=slo, batches=exe.batches, lm=lm,
                      setup_s=0.0, failed=set(), trace=tr)
    return run, exe, wall


def readings(run, exe, wall: float, log) -> dict:
    import numpy as np

    from orloj_bench import harness
    from repro_torch.core import spans as sp

    sim, batches = run.sim, exe.batches
    n = len(batches)
    row = {"batches": n, "wall_s": wall, "wall_us_per_batch": wall * 1e6 / n,
           # the wrapper's charge less the replay: the host part the clock charges
           "charged_host_us_per_batch": 1e3 * sum(b["ms"] - b["inner_ms"] for b in batches) / n,
           "mean_batch": float(np.mean([b["k"] for b in batches])),
           "hook_ms": sim.hook_ms, "hook_calls": sim.hook_calls,
           "hook_sum_over_sched_time": sum(sim.hook_ms.values()) / sim.sched_time_ms}
    for m in ("latency_p95_ms", "goodput_tok_s", "finish_rate", "sched_us_per_decision",
              "sched_us_per_next_batch", "eq3_err", "device_idle"):
        row[m] = harness.load_metric(m)(run)
    if log is None:
        return row
    (lo, hi, _), = log.intervals(sp.LOOP_RUN)
    inside = {name: log.intervals(name) for name in sp.NAMES}
    inside = {name: iv[(iv[:, 0] >= lo) & (iv[:, 1] <= hi)] for name, iv in inside.items()}
    host_ns = sum(int((inside[k][:, 1] - inside[k][:, 0]).sum()) for k in (sp.EXEC_PAD, sp.EXEC_H2D))
    row |= {
        "exec_host_us_per_batch": host_ns / 1e3 / len(inside[sp.EXEC_PAD]),
        "exec_us_per_batch": {k: float((inside[k][:, 1] - inside[k][:, 0]).mean() / 1e3)
                              for k in (sp.EXEC_PAD, sp.EXEC_H2D, sp.EXEC_REPLAY)},
        "queue_wait_p95_ms": float(np.percentile(log.queue_wait_ms, 95)),
        "queue_wait_p50_ms": float(np.percentile(log.queue_wait_ms, 50)),
        "batch_k_at_dispatch": float(inside[sp.SCHED_NEXT_BATCH][:, 2][
            inside[sp.SCHED_NEXT_BATCH][:, 2] > 0].mean()),
        "captures_in_window": len(inside[sp.EXEC_CAPTURE]),
        "spans_in_window": sum(len(iv) for iv in inside.values()),
        "spans_dropped": log.dropped,
    }
    if run.trace is not None:
        gaps = run.trace.idle_gaps()
        win = run.trace.window_s
        row["idle_charged"] = 100.0 * log.covered_ns(sp.CHARGED, gaps) / 1e9 / win
        row["idle_s_under"] = {name: log.covered_ns(name, gaps) / 1e9 for name in sp.NAMES
                               if name not in (sp.LOOP_RUN, sp.ENGINE_FIT)}
        row["idle_s_under_no_span"] = (
            float((gaps[:, 1] - gaps[:, 0]).sum()) / 1e9
            - log.covered_ns([x for x in sp.NAMES if x != sp.LOOP_RUN], gaps) / 1e9)
        row["window_s"], row["busy_s"] = win, run.trace.busy_s()
        row["harness_idle_gaps"] = harness.breakdown(run.trace, exe.spans)["idle_gaps"]
    return row


def span_cost_ns(reps: int = 200_000) -> dict:
    """A span's own cost on this host, timed alone: one ``time.time_ns`` read
    and one ``add``, and a ``close``."""
    from repro_torch.core import spans as sp

    log = sp.SpanLog(capacity=reps)
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        log.add(sp.EXEC_H2D, 0, time.time_ns())
    t1 = time.perf_counter_ns()
    for _ in range(reps):
        log.close(sp.SCHED_ON_ARRIVAL, 1e-6)
    t2 = time.perf_counter_ns()
    return {"add_and_read_ns": (t1 - t0) / reps, "close_ns": (t2 - t1) / reps}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="glm4_9b.bimodal.r80")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=0.0, help="default: BENCHMARK.json's")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from orloj_bench import harness
    from repro_torch.core.spans import ENGINE_FIT, EXEC_CAPTURE, SpanLog
    from repro_torch.kernels import _build

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    bench = json.loads(harness.BENCH_FILE.read_text())
    seconds = args.seconds or bench["run_seconds"]
    cell = harness.load_cell(args.workload, bench)
    out = {"workload": args.workload, "seed": args.seed, "seconds": seconds,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "span_cost": span_cost_ns(), "windows": []}
    fit_log = SpanLog()
    engine, lm, _ = harness.setup(cell, args.seed, device, spans=fit_log)
    engine.executor.spans = None
    out["setup"] = {"setup_s": time.perf_counter() - T_START,
                    "setup_fit_s": fit_log.ns[ENGINE_FIT] / 1e9,
                    "captures": fit_log.calls[EXEC_CAPTURE],
                    "capture_s": fit_log.ns[EXEC_CAPTURE] / 1e9,
                    "nvcc_runs": _build.nvcc_runs, "nvcc_seconds": _build.nvcc_seconds,
                    **gemm_share(cell, engine)}
    print(json.dumps(out["setup"] | {"span_cost": out["span_cost"]}), flush=True)
    modes = ["off", "on", "on", "off"] * args.pairs + (["traced"] if device.type == "cuda" else [])
    for mode in modes:
        log = None if mode == "off" else SpanLog()
        run, exe, wall = window(cell, engine, lm, args.seed, seconds, device, log, mode == "traced")
        row = {"mode": mode} | readings(run, exe, wall, log)
        out["windows"].append(row)
        print(json.dumps(row), flush=True)
        del run, exe
    if args.pairs:
        by = {m: [w for w in out["windows"] if w["mode"] == m] for m in ("off", "on")}
        out["on_minus_off"] = {
            k: statistics.median(w[k] for w in by["on"]) - statistics.median(w[k] for w in by["off"])
            for k in ("charged_host_us_per_batch", "wall_us_per_batch", "latency_p95_ms",
                      "goodput_tok_s", "finish_rate")}
        print(json.dumps({"on_minus_off": out["on_minus_off"]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
