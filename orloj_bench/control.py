"""The readings that a cell's limits are set from: the program's numbers and
the lower-precision control's, seed by seed, in one process.

    python3 orloj_bench/control.py --workload glm4_9b.bimodal.r80 --seeds 1,2,3 --seconds 8

One set-up; for each seed the weights are drawn again in place (the
program's graphs read them), one window at the cell's own load is served,
and its kept requests are compared with the float32 reference: the
program's logits, and the control's, which is the reference computed with
TF32 products (the nearest precision below the configuration's float32)
in the program's place.  Writes every reading as JSON to ``--out``.  The
benchmark's own runs never run the control.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from orloj_bench import harness, reference
    from orloj_bench.weights import make_weights

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    engine, lm, w = harness.setup(cell, seeds[0], device)
    out = {"workload": args.workload, "seconds": args.seconds, "seeds": []}
    for seed in seeds:
        make_weights(cell.config, seed, device, out=w)
        sim, requests, exe, _ = harness.window(cell, engine, lm, seed, args.seconds, False, device)
        sample = exe.sample()
        program = harness.compare(cell.config, sample, w)
        control = []
        for r, _ in sample:
            tokens = torch.tensor(r.payload)
            ref = reference.logits(cell.config, w, tokens)
            low = reference.logits(cell.config, w, tokens, tf32=True)
            control.append(harness.readings(ref, low) | {"rid": r.rid, "len": len(r.payload)})
        row = {"seed": seed, "compared": len(program),
               "positions": sum(p["len"] for p in program),
               "program": {k: max(p[k] for p in program) for k in ("top_gap", "logit_err")},
               "control": {k: max(p[k] for p in control) for k in ("top_gap", "logit_err")},
               "program_rows": program, "control_rows": control}
        out["seeds"].append(row)
        print(json.dumps({k: row[k] for k in ("seed", "compared", "positions", "program",
                                              "control")}), flush=True)
        del exe, sample
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
