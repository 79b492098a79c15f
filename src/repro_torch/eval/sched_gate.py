"""CI regression gate over the ``BENCH_sched.json`` scheduler-throughput
artifact (ROADMAP "BENCH_sched.json regression gate" item).

``benchmarks/queue_micro.py::sched_throughput`` measures arrival-path
throughput and ``next_batch`` latency at 10²/10³/10⁴ pending and writes
them to ``BENCH_sched.json``.  This gate compares a freshly measured
artifact against the committed baseline and fails CI when the hot path
regresses beyond a *loose* ratio band — 2.5× by default, because
absolute rates swing across shared CI runners (DESIGN.md §8 documents
the band).  The band started at 3×; a season of runs showed run-to-run
wobble of the gated numbers well under 2× even on loaded runners, so
2.5 keeps the same headroom while catching smaller real regressions.

    # regenerate BENCH_sched.json in place, then compare to the committed one
    cp BENCH_sched.json /tmp/sched_baseline.json
    python -m benchmarks.run --only sched
    python -m repro.eval.sched_gate --baseline /tmp/sched_baseline.json

Checked per pending-count size: ``vectorized_arrivals_per_s`` must not
fall below ``baseline / max_ratio`` and ``next_batch_us`` must not exceed
``baseline * max_ratio``.  Speedup-vs-scalar ratios are *not* gated for
the scheduler sections (both paths slow down together on a loaded runner,
so the ratio is stable but uninformative about regressions).

The ``eventloop`` section (array engine vs the scalar oracle loop,
``benchmarks/queue_micro.py::eventloop_throughput``) is gated the other
way round: its *speedup* IS the claim — both engines replay the identical
trace in the same process, so their ratio is immune to runner load — and
must stay >= :data:`MIN_EVENTLOOP_SPEEDUP` at every size (the ISSUE-level
"≥5× end-to-end at 10⁴+ requests" floor).  ``array_events_per_s`` also
gets the loose absolute ratio band against the committed baseline.

The ``token_decode`` section (``queue_micro.py::token_decode``) gates
the continuous-batching decode-step hook per *call*: ``on_decode_step``
fires on every token boundary of a running decode batch, so unlike
``next_batch`` it has no batch of admissions to amortize against — its
cost multiplies into every generated token.  Both schedulers' measured
``decision_us`` must stay under :data:`MAX_DECODE_HOOK_US` absolutely
and within the ratio band of the committed baseline.

The ``residency`` section (``queue_micro.py::residency_churn``,
DESIGN.md §13) gates the multi-model weights-residency machinery both
ways: ``ResidencyState.acquire`` sits on the dispatch path of every
residency-managed batch and is budgeted absolutely per call
(:data:`MAX_ACQUIRE_US`, per eviction policy), and the end-to-end
events/s cost of running the event loop under a churning plan versus
residency-free on the same trace must stay under
:data:`MAX_RESIDENCY_SLOWDOWN` per engine (same-process ratio, immune
to runner load, like the fault slowdown cap).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Mapping

__all__ = [
    "check",
    "main",
    "MIN_EVENTLOOP_SPEEDUP",
    "MAX_FAULT_SLOWDOWN",
    "MAX_DECODE_HOOK_US",
    "MAX_ACQUIRE_US",
    "MAX_RESIDENCY_SLOWDOWN",
]

DEFAULT_MAX_RATIO = 2.5
# Absolute floor on the array engine's measured end-to-end speedup over
# the scalar loop.  Measured ~5.5x at 1e4 and ~8.3x at 1e5 requests on
# the benchmark's tick-quantized trace; 5.0 is the acceptance floor.
MIN_EVENTLOOP_SPEEDUP = 5.0
# Cap on the fault path's end-to-end cost (``eventloop_faults`` section):
# fault-free events/s over faulted events/s on the same trace, per
# engine.  The faulted replay does strictly more work (crash aborts,
# retry re-queues via the per-request object path, straggler draws), so
# the slowdown is structurally > 1 on the array engine, whose fault-free
# bulk paths it bypasses (measured ~2.1x there, ~1.0x on the scalar
# loop); the cap keeps the retry machinery from quietly bloating the
# engines (and since both modes run in one process, the ratio is immune
# to runner load, like the speedup floor above).
MAX_FAULT_SLOWDOWN = 3.0
# Absolute per-call budget on the token schedulers' metered decision
# time (``token_decode`` section, hook-dominated): the decode-step hook
# runs once per token step, so its cost is a floor under every TPOT the
# serving layer can deliver.  Measured ~180us/call for the length-aware
# scheduler (admission sort + feasibility sweep at ~0.8 load) and
# <1us/call for token FCFS; 500 gives ~2.8x headroom for loaded runners
# while still catching an accidentally quadratic hook.
MAX_DECODE_HOOK_US = 500.0
# Absolute per-call budget on ``ResidencyState.acquire`` (``residency``
# section): the acquire runs once per residency-managed batch dispatch,
# under churn (measured on a ~1-resident-model cache where most calls
# evict + load).  Measured ~0.6us/call for LRU and ~1.0us/call for the
# cost-aware policy (which scans the cache for the cheapest victim); 25
# gives wide runner headroom while catching an accidentally quadratic
# victim scan.
MAX_ACQUIRE_US = 25.0
# Cap on the residency tier's end-to-end cost (``residency`` section):
# residency-free events/s over residency-managed events/s on the same
# multi-model FIFO trace, per engine.  The managed replay does strictly
# more work (cache lookups, eviction, stall accounting on every batch),
# but all of it is dict-sized — measured ~1.04x on the array engine and
# ~1.02x on the scalar loop; 2.0 keeps the residency machinery from
# quietly growing into the dispatch hot path (same-process ratio, immune
# to runner load).
MAX_RESIDENCY_SLOWDOWN = 2.0


def check(
    baseline: Mapping, fresh: Mapping, max_ratio: float = DEFAULT_MAX_RATIO
) -> list[str]:
    """Compare two ``BENCH_sched.json`` documents; returns failure lines
    (empty = gate passes)."""
    if max_ratio < 1.0:
        raise ValueError(f"max_ratio must be >= 1, got {max_ratio}")
    fails: list[str] = []
    base_sizes = baseline.get("sizes") or {}
    fresh_sizes = fresh.get("sizes") or {}
    if not base_sizes:
        return ["baseline artifact has no 'sizes' section"]
    for size, base in sorted(base_sizes.items(), key=lambda kv: int(kv[0])):
        cur = fresh_sizes.get(size)
        if cur is None:
            fails.append(f"n={size}: missing from the fresh artifact")
            continue
        b, f = base["vectorized_arrivals_per_s"], cur["vectorized_arrivals_per_s"]
        if f * max_ratio < b:
            fails.append(
                f"n={size}: arrival throughput {f:.0f}/s is more than "
                f"{max_ratio:g}x below the baseline {b:.0f}/s"
            )
        b_us, f_us = base["next_batch_us"], cur["next_batch_us"]
        if f_us > b_us * max_ratio:
            fails.append(
                f"n={size}: next_batch latency {f_us:.0f}us is more than "
                f"{max_ratio:g}x above the baseline {b_us:.0f}us"
            )
    fails.extend(_check_eventloop(baseline, fresh, max_ratio))
    fails.extend(_check_faults(baseline, fresh, max_ratio))
    fails.extend(_check_token_decode(baseline, fresh, max_ratio))
    fails.extend(_check_residency(baseline, fresh, max_ratio))
    return fails


def _check_eventloop(
    baseline: Mapping, fresh: Mapping, max_ratio: float
) -> list[str]:
    """Gate the ``eventloop`` section: the array/scalar speedup must hold
    the absolute :data:`MIN_EVENTLOOP_SPEEDUP` floor at every size, and
    ``array_events_per_s`` must stay within the ratio band of the
    committed baseline.  A baseline without the section (pre-array-engine
    artifacts) skips the gate entirely."""
    base_el = baseline.get("eventloop") or {}
    base_sizes = base_el.get("sizes") or {}
    if not base_sizes:
        return []
    fresh_sizes = (fresh.get("eventloop") or {}).get("sizes") or {}
    fails: list[str] = []
    for size, base in sorted(base_sizes.items(), key=lambda kv: int(kv[0])):
        cur = fresh_sizes.get(size)
        if cur is None:
            fails.append(f"eventloop n={size}: missing from the fresh artifact")
            continue
        speedup = cur["speedup"]
        if speedup < MIN_EVENTLOOP_SPEEDUP:
            fails.append(
                f"eventloop n={size}: array/scalar speedup {speedup:.2f}x "
                f"is below the {MIN_EVENTLOOP_SPEEDUP:g}x floor"
            )
        b, f = base["array_events_per_s"], cur["array_events_per_s"]
        if f * max_ratio < b:
            fails.append(
                f"eventloop n={size}: array throughput {f:.0f} events/s is "
                f"more than {max_ratio:g}x below the baseline {b:.0f}/s"
            )
    return fails


def _check_faults(
    baseline: Mapping, fresh: Mapping, max_ratio: float
) -> list[str]:
    """Gate the ``eventloop_faults`` section: per engine and size the
    measured fault slowdown (fault-free over faulted events/s, same
    process, same trace) must stay under :data:`MAX_FAULT_SLOWDOWN`, and
    the faulted array throughput within the ratio band of the committed
    baseline.  A baseline without the section (pre-fault-tier artifacts)
    skips the gate entirely."""
    base_sizes = (baseline.get("eventloop_faults") or {}).get("sizes") or {}
    if not base_sizes:
        return []
    fresh_sizes = (fresh.get("eventloop_faults") or {}).get("sizes") or {}
    fails: list[str] = []
    for size, base in sorted(base_sizes.items(), key=lambda kv: int(kv[0])):
        cur = fresh_sizes.get(size)
        if cur is None:
            fails.append(
                f"eventloop_faults n={size}: missing from the fresh artifact"
            )
            continue
        for engine in ("scalar", "array"):
            slowdown = cur[f"{engine}_fault_slowdown"]
            if slowdown > MAX_FAULT_SLOWDOWN:
                fails.append(
                    f"eventloop_faults n={size}: {engine} fault slowdown "
                    f"{slowdown:.2f}x exceeds the {MAX_FAULT_SLOWDOWN:g}x cap"
                )
        b = base["array_faulted_events_per_s"]
        f = cur["array_faulted_events_per_s"]
        if f * max_ratio < b:
            fails.append(
                f"eventloop_faults n={size}: faulted array throughput "
                f"{f:.0f} events/s is more than {max_ratio:g}x below the "
                f"baseline {b:.0f}/s"
            )
    return fails


def _check_token_decode(
    baseline: Mapping, fresh: Mapping, max_ratio: float
) -> list[str]:
    """Gate the ``token_decode`` section: per size and token scheduler,
    the measured per-decision time must stay under the absolute
    :data:`MAX_DECODE_HOOK_US` budget (the hook fires every token step;
    its cost floors the deliverable TPOT) and within the ratio band of
    the committed baseline.  A baseline without the section
    (pre-continuous-batching artifacts) skips the gate entirely."""
    base_sizes = (baseline.get("token_decode") or {}).get("sizes") or {}
    if not base_sizes:
        return []
    fresh_sizes = (fresh.get("token_decode") or {}).get("sizes") or {}
    fails: list[str] = []
    for size, base in sorted(base_sizes.items(), key=lambda kv: int(kv[0])):
        cur = fresh_sizes.get(size)
        if cur is None:
            fails.append(
                f"token_decode n={size}: missing from the fresh artifact"
            )
            continue
        for system in ("token_fcfs", "token_orloj"):
            us = cur[f"{system}_decision_us"]
            if us > MAX_DECODE_HOOK_US:
                fails.append(
                    f"token_decode n={size}: {system} decision time "
                    f"{us:.0f}us exceeds the {MAX_DECODE_HOOK_US:g}us "
                    f"per-call budget"
                )
            b_us = base[f"{system}_decision_us"]
            if us > b_us * max_ratio:
                fails.append(
                    f"token_decode n={size}: {system} decision time "
                    f"{us:.1f}us is more than {max_ratio:g}x above the "
                    f"baseline {b_us:.1f}us"
                )
    return fails


def _check_residency(
    baseline: Mapping, fresh: Mapping, max_ratio: float
) -> list[str]:
    """Gate the ``residency`` section: per eviction policy the measured
    ``acquire`` cost must stay under the absolute :data:`MAX_ACQUIRE_US`
    per-call budget and within the ratio band of the committed baseline;
    per size and engine the end-to-end residency slowdown (residency-free
    over residency-managed events/s, same process, same trace) must stay
    under :data:`MAX_RESIDENCY_SLOWDOWN`, and the managed array
    throughput within the ratio band.  A baseline without the section
    (pre-multi-model artifacts) skips the gate entirely."""
    base_res = baseline.get("residency") or {}
    if not base_res:
        return []
    fresh_res = fresh.get("residency") or {}
    fails: list[str] = []
    base_acq = base_res.get("acquire") or {}
    fresh_acq = fresh_res.get("acquire") or {}
    for policy in ("lru", "cost_aware"):
        key = f"{policy}_acquire_us"
        if key not in base_acq:
            continue
        us = fresh_acq.get(key)
        if us is None:
            fails.append(f"residency acquire: {key} missing from the "
                         f"fresh artifact")
            continue
        if us > MAX_ACQUIRE_US:
            fails.append(
                f"residency acquire: {policy} cost {us:.1f}us exceeds the "
                f"{MAX_ACQUIRE_US:g}us per-call budget"
            )
        if us > base_acq[key] * max_ratio:
            fails.append(
                f"residency acquire: {policy} cost {us:.2f}us is more than "
                f"{max_ratio:g}x above the baseline {base_acq[key]:.2f}us"
            )
    base_sizes = base_res.get("sizes") or {}
    fresh_sizes = fresh_res.get("sizes") or {}
    for size, base in sorted(base_sizes.items(), key=lambda kv: int(kv[0])):
        cur = fresh_sizes.get(size)
        if cur is None:
            fails.append(f"residency n={size}: missing from the fresh "
                         f"artifact")
            continue
        for engine in ("scalar", "array"):
            slowdown = cur[f"{engine}_residency_slowdown"]
            if slowdown > MAX_RESIDENCY_SLOWDOWN:
                fails.append(
                    f"residency n={size}: {engine} residency slowdown "
                    f"{slowdown:.2f}x exceeds the "
                    f"{MAX_RESIDENCY_SLOWDOWN:g}x cap"
                )
        b = base["array_managed_events_per_s"]
        f = cur["array_managed_events_per_s"]
        if f * max_ratio < b:
            fails.append(
                f"residency n={size}: managed array throughput {f:.0f} "
                f"events/s is more than {max_ratio:g}x below the baseline "
                f"{b:.0f}/s"
            )
    return fails


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", required=True,
                    help="committed BENCH_sched.json to gate against")
    ap.add_argument("--fresh", default="BENCH_sched.json",
                    help="freshly measured artifact (default: BENCH_sched.json)")
    ap.add_argument("--max-ratio", type=float, default=DEFAULT_MAX_RATIO,
                    help="tolerated regression ratio (default %(default)s)")
    args = ap.parse_args(argv)
    with open(args.baseline) as f:
        baseline = json.load(f)
    with open(args.fresh) as f:
        fresh = json.load(f)
    fails = check(baseline, fresh, args.max_ratio)
    for line in fails:
        print(f"FAIL {line}", file=sys.stderr)
    status = "FAIL" if fails else "PASS"
    print(f"sched gate: {status} ({args.fresh} vs {args.baseline}, "
          f"band {args.max_ratio:g}x)")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
