"""Find a (configuration, mix)'s knee: the highest offered rate whose window
finishes at least 90% of its counted requests within the SLO (DistServe's
attainment rule, arXiv:2401.09670).

    python3 orloj_bench/sweep.py --config glm4_9b --mix bimodal --rates 6,8,10,12 --seconds 20

One set-up (weights, engine, the Eq.-3 fit), then one window at each rate,
each through the same path as a cell's run.  The SLO is 3 × the mix's p99
alone-time under this fit (``launch/serve.py``'s operating point) unless
``--slo-ms`` fixes it (to sweep again at a cell's fixed SLO).  Prints the
fit, the SLO and each window's numbers (``busy_share``: the executor's
time over the window's virtual time), and writes them as JSON to
``--out``.  Its output is what a cell's traffic
file fixes once: no run derives a rate or an SLO from its own fit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--mix", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests per second")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--slo-ms", type=float, default=0.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from orloj_bench import harness, traffic

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = harness.Cell(name=f"{args.config}.{args.mix}.sweep",
                        config=traffic.load("configs", args.config), traffic={},
                        mix=traffic.load("mixes", args.mix),
                        checks=traffic.load("checks", args.config), end_to_end=[], per_layer=[])
    engine, lm, _ = harness.setup(cell, args.seed, device)
    buckets = engine.cfg.buckets
    warm = traffic.draw_lengths(cell.mix, np.random.default_rng(cell.mix["base_seed"]), 4096)
    alone = lm.c0 + lm.c1 * np.array([traffic.bucket_of(int(k), buckets) for k in warm])
    p99 = float(np.quantile(alone, 0.99))
    slo = args.slo_ms or 3.0 * p99
    out = {"config": args.config, "mix": args.mix, "c0_ms": lm.c0, "c1_ms_per_token": lm.c1,
           "p99_alone_ms": p99, "slo_ms": slo, "seconds": args.seconds, "seed": args.seed,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "setup_s": time.perf_counter() - T_START, "rates": []}
    print(f"fit c0 {lm.c0:.4f} ms, c1 {lm.c1 * 1e3:.4f} ms/ktok; p99 alone {p99:.3f} ms; "
          f"slo {slo:.3f} ms", flush=True)
    read = {m: harness.load_metric(m) for m in
            ("finish_rate", "latency_p95_ms", "goodput_tok_s", "pad_share", "step_mfu")}
    for rate in [float(r) for r in args.rates.split(",")]:
        t0 = time.perf_counter()
        cell.traffic = {"mix": args.mix, "rate_rps": rate, "slo_ms": slo}
        sim, requests, exe, _ = harness.window(cell, engine, lm, args.seed, args.seconds, False,
                                               device)
        counted = harness.count(requests, sim.makespan_ms, slo)
        run = harness.Run(cell=cell, sim=sim, counted=counted,
                          t_end_ms=sim.makespan_ms, slo_ms=slo, batches=exe.batches, lm=lm,
                          setup_s=0.0, failed=set())
        row = {"rate_rps": rate, "counted": len(counted), "batches": len(exe.batches),
               "mean_batch": float(np.mean([b["k"] for b in exe.batches])),
               "dropped": sim.n_dropped, "late": sim.n_finished_late,
               "busy_share": sum(b["ms"] for b in exe.batches) / sim.makespan_ms,
               "wall_s": time.perf_counter() - t0}
        row |= {m: f(run) for m, f in read.items()}
        out["rates"].append(row)
        print(json.dumps(row), flush=True)
        del exe
    met = [r["rate_rps"] for r in out["rates"] if r["finish_rate"] >= 90.0]
    out["knee_rps"] = max(met) if met else None
    print(f"knee {out['knee_rps']} rps at slo {slo:.3f} ms", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
