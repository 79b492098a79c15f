#!/usr/bin/env python3
"""Search the float32 GEMM's launch plans on the card, at GLM-4-9B's weight
products.

    python3 scripts/gemm_plans.py [--rows 1,8,32,64,128,256,512,2048] [--out build/gemm_plans.json]

For each product (q and o: 4096 x 4096; k and v: 4096 x 256; gate and up:
4096 x 13696; down: 13696 x 4096; the head: 4096 x 151552) and token
count M, times ``gemm.gemm_plan``'s plan and every other plan of the same
token width (and, above 128 rows, of widths 64 and 128) with 1 to 64
splits along K (those the launcher takes) and with fewer ring stages, each by graph replay between CUDA events, and
holds each plan's output against the plan's own within float32's
rounding.  Prints one line a shape: the plan's time, the fastest plan's,
their ratio, the weight-read and three-pass bounds; writes every timing to
``--out``.  ``gemm_plan``'s rules are checked against these searches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import kernel_table  # beside this script; puts src/ on the path

PRODUCTS = {"q/o": (4096, 4096), "k/v": (4096, 256), "gate/up": (4096, 13696),
            "down": (13696, 4096), "head": (4096, 151552)}
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def _label(plan) -> str:
    return f"T{plan.tokens}xS{plan.splits}xst{plan.stages}"


def main() -> int:
    import torch

    from repro_torch.kernels import _build, gemm

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1,8,32,64,128,256,512,2048")
    ap.add_argument("--products", default=",".join(PRODUCTS))
    ap.add_argument("--out", default="build/gemm_plans.json")
    args = ap.parse_args()
    card = kernel_table.card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = _build.sm_count(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name in args.products.split(","):
        k, n = PRODUCTS[name]
        w = torch.randn((k, n), generator=gen, device="cuda") / k**0.5
        for m in (int(r) for r in args.rows.split(",")):
            x = torch.randn((m, k), generator=gen, device="cuda")
            plan = gemm.gemm_plan(m, n, k, sms)
            want = gemm.gemm_cuda(x, w, plan)
            scale = want.abs().max().item()
            timings = {}
            candidates = {plan}
            for tokens in {plan.tokens} | ({64, 128} if m > 128 else set()):
                base = dataclasses.replace(plan, tokens=tokens, stages=gemm.max_stages(tokens),
                                           shared_bytes=gemm.shared_bytes(tokens, gemm.max_stages(tokens)))
                for s in SPLITS:
                    splits, per = gemm.split_plan(k, s)
                    if splits != s or gemm.partial_floats(m, n, s) * 4 > 1 << 30:
                        continue
                    candidates.add(dataclasses.replace(base, splits=splits, tiles_per_split=per))
            for st in range(2, plan.stages):
                candidates.add(dataclasses.replace(plan, stages=st, shared_bytes=gemm.shared_bytes(plan.tokens, st)))
            for cand in sorted(candidates, key=lambda p: (p.tokens, p.splits, p.stages)):
                got = gemm.gemm_cuda(x, w, cand)
                err = (got - want).abs().max().item() / scale
                if err > 1e-5:
                    raise SystemExit(f"{name} m={m} {cand}: differs from the plan's output by {err:.3e}")
                timings[_label(cand)] = kernel_table.time_ms(lambda c=cand: gemm.gemm_cuda(x, w, c), reps=None, graphs=3)
            mine = timings[_label(plan)]
            best = min(timings, key=timings.get)
            bytes_ms = kernel_table.weight_bytes_bound_s(n, k) * 1e3
            work_ms = kernel_table.work_bound_s(m, n, k) * 1e3
            tflops = gemm.flops(m, n, k) / mine / 1e9
            print(f"{name} M={m} (K {k}, N {n}): plan T{plan.tokens} S{plan.splits} st{plan.stages} "
                  f"{mine:.5f} ms ({tflops:.1f} TFLOP/s); best {best} {timings[best]:.5f} ms; "
                  f"plan/best {mine / timings[best]:.3f}; bounds: bytes {bytes_ms:.5f} ms, "
                  f"three passes {work_ms:.5f} ms", flush=True)
            rows.append({"product": name, "m": m, "k": k, "n": n, "plan": dataclasses.asdict(plan),
                         "ms": timings, "bytes_bound_ms": bytes_ms, "work_bound_ms": work_ms})
            del x, want
        del w
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "sms": sms, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
