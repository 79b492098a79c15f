"""Paper-claims conformance gates over an experiment result set.

The paper's core quantitative claim (Tables 2-5, Figs. 8-9) is an
*ordering*: under tight SLOs on high-variance workloads ORLOJ finishes
more requests than Clockwork/Nexus/Clipper, while staying comparable on
static workloads.  Absolute finish rates depend on hardware constants and
trace scaling, so the gate checks the orderings, not the magnitudes:

- ``tight-slo-dominance`` — on every dynamic workload case at SLO scale
  strictly below :data:`TIGHT_SLO_MAX`, ORLOJ's seed-averaged finish
  rate >= every baseline's (strict: no tolerance — the observed margins
  are the evidence, and they are reported per cell);
- ``nexus-slo2-gap`` — in the intermediate window
  :data:`NEXUS_SLO2_WINDOW` (≈2 x P99), where Nexus's fixed-batch plan
  is genuinely competitive in this repro, the seed-mean
  nexus-over-orloj gap stays under :data:`NEXUS_SLO2_BOUND` — the
  regime is *bounded*, not ordered (DESIGN.md §7);
- ``static-parity`` — on static workloads ORLOJ is within
  :data:`STATIC_NOISE_BAND` of the best baseline (on no-variance
  workloads all systems degenerate to near-identical batching; the band
  covers batching-order noise, sized from the observed seed-to-seed
  spread, ~1.5x the per-system std of 0.05);
- ``slo-monotonicity`` — relaxing the SLO never *costs* a system more
  than :data:`MONO_SLACK` finish rate (sanity: the grid is measuring SLO
  pressure, not an artifact).

- ``scale-out-dispatch`` — on multi-worker pools the distribution-aware
  ``jsq_work`` front-end never trails ``round_robin`` by more than
  :data:`SCALEOUT_SLACK` seed-mean finish rate (the §3.1 scale-out path:
  expected-work balancing must at least match blind rotation, and on
  heterogeneous pools it should win outright).  Evaluated only when the
  result set contains pool cells (the tiny grid has none);
- ``p2c-dispatch`` — same ordering for the two-probe ``p2c`` front-end
  vs ``round_robin`` within :data:`P2C_SLACK` (two load probes per
  arrival already recover most of the full-scan ordering; on the gated
  hetero cells p2c wins on every seed, mean margin +0.011);
- ``homog-pool-parity`` — on *homogeneous* pools every dispatch policy's
  seed-mean finish rate sits within :data:`HOMOG_BAND` of the best
  (identical replicas leave nothing for load-awareness to exploit;
  observed spread 0.0007, the band covers tie-break noise);
- ``cluster-wall-budget`` — every wall-budgeted cell (fleet-scale
  ``cluster`` grids, ``wall_budget_s > 0``) replays inside its budget —
  the array engine's performance contract, enforced in CI;
- ``array-scalar-equivalence`` — paired cells identical up to
  ``engine`` produce identical outcomes (finish counts, makespan,
  decision count, and under a fault plan the per-terminal-state counts):
  the fleet grids' correctness anchor to the scalar oracle loop;
- ``fault-free-noop`` — a cell carrying a *disabled*
  :class:`~repro.serving.faults.FaultPlan` is bitwise identical to the
  same cell with no plan at all (the fault hooks cost nothing
  observable — DESIGN.md §11);
- ``graceful-degradation`` — on the chaos grid's crash-severity ladder,
  per-system finish rates fall monotonically (within
  :data:`FAULT_RISE_SLACK`), never cliff by more than
  :data:`FAULT_CLIFF` between adjacent levels, and ORLOJ keeps its lead
  (within :data:`FAULT_DOMINANCE_SLACK`) at every level.

Truncated results (a ``wall_budget_s`` overrun cut the replay off) are
excluded from every outcome claim and failed by ``cluster-wall-budget``.

This layer is stage 4 of the grid-cell lifecycle (spec → seeded
RequestSet → result → claim, see :mod:`repro.eval.spec`): it consumes
:class:`ExperimentResult` values regardless of which substrate produced
them — engine-substrate results flow through the same claim functions
(cells from different substrates are never averaged together, because the
grouping label carries the substrate).

Aggregation is a plain mean over the grid's seeds, grouped per experiment
(workload case, utilization, n_requests, SLO scale, system) so cells from
different sweeps are never averaged together; every simulation is
deterministic, so a claim's verdict is reproducible bit-for-bit (engine
cells measure real hardware and are reproducible only up to timing noise).
The three paper claims only look at single-worker, default-config cells —
ablation and sensitivity sweeps (``sched_cfg``, ``time_scale``, overhead
charging) are excluded, and pool cells are the scale-out claim's domain.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Any, Iterable, Mapping, Sequence

from ..serving.faults import FaultPlan
from .spec import ExperimentResult, ExperimentSpec
from .substrate import parse_substrate
from .workloads import DYNAMIC_FAMILIES

__all__ = [
    "STATIC_NOISE_BAND",
    "MONO_SLACK",
    "TIGHT_SLO_MAX",
    "SCALEOUT_SLACK",
    "P2C_SLACK",
    "HOMOG_BAND",
    "FAULT_RISE_SLACK",
    "FAULT_CLIFF",
    "FAULT_DOMINANCE_SLACK",
    "NEXUS_SLO2_WINDOW",
    "NEXUS_SLO2_BOUND",
    "TOKEN_TIGHT_SLO_MAX",
    "COLDSTART_SLACK",
    "ClaimResult",
    "claim_token_length_awareness",
    "claim_cold_start_dominance",
    "claim_single_model_noop",
    "claim_scaleout_dispatch",
    "claim_p2c_dispatch",
    "claim_homog_pool_parity",
    "claim_cluster_wall_budget",
    "claim_array_scalar_equivalence",
    "claim_fault_free_noop",
    "claim_graceful_degradation",
    "claim_nexus_slo2_gap",
    "evaluate_claims",
    "format_report",
]

# Documented gate constants (DESIGN.md §7).
# "Tight SLO" = scale strictly below 1.75 x P99.  The dominance regime
# this repro actually reproduces ends there: at scales 1.75-2.25 Nexus's
# fixed-batch plan is genuinely competitive (the slo2-bimodal diagnostic
# grid measures the gap and claim_nexus_slo2_gap *bounds* it instead of
# asserting an ordering the code does not reproduce — DESIGN.md §7).
TIGHT_SLO_MAX = 1.75
STATIC_NOISE_BAND = 0.08  # parity band on static workloads
MONO_SLACK = 0.05  # tolerated finish-rate dip when relaxing the SLO
# Tolerated jsq_work-vs-round_robin deficit on pool cells.  On the gated
# hetero pool cells jsq_work wins on every seed (seed-mean margin +0.035
# observed); the slack covers dispatch-tie-break noise only — about 10
# requests at the pool cells' n=500 — without masking a real ordering flip.
SCALEOUT_SLACK = 0.02
# Tolerated p2c-vs-round_robin deficit.  p2c probes only two pools/replicas
# per arrival, so its margin over blind rotation is smaller than jsq_work's
# full scan (hetero seed-mean +0.011 observed, positive on every seed); the
# same 0.02 slack covers probe-sampling noise without masking a flip.
P2C_SLACK = 0.02
# Parity band between dispatch policies on homogeneous pools: identical
# replicas leave load-awareness nothing to exploit, so every policy must
# land within the band of the best (observed spread 0.0007 across
# round_robin/jsq_work/p2c on the gated homog cells).
HOMOG_BAND = 0.02
# Graceful-degradation constants (chaos grid, DESIGN.md §11).  On the
# gated severity ladder (2-worker bimodal @ slo 1.5, MTTF levels
# off/mild/moderate/severe) the observed per-system seed-mean rises are
# <= 0.002, adjacent-level drops <= 0.035, and ORLOJ leads every
# baseline by >= 0.02 at every level.
FAULT_RISE_SLACK = 0.02  # tolerated finish-rate *rise* as severity grows
FAULT_CLIFF = 0.10  # max adjacent-severity-level finish-rate drop
FAULT_DOMINANCE_SLACK = 0.03  # orloj >= baseline - slack at each level
# Intermediate-SLO diagnostic window (slo2-bimodal grid): the SLO scales
# where Nexus is competitive in this repro.  The bounding claim caps the
# seed-mean nexus-over-orloj gap (observed max +0.035 at scale 2.25).
NEXUS_SLO2_WINDOW = (1.75, 2.25)
NEXUS_SLO2_BOUND = 0.06
# Token-mode tightness boundary (tokens grids, DESIGN.md §12): TPOT
# scales strictly below it are "tight" — the regime where admission that
# knows the output-length distributions must beat length-blind FCFS.
TOKEN_TIGHT_SLO_MAX = 1.75
# Cold-start dominance (multi-model grids, DESIGN.md §13): residency-aware
# dispatch must beat residency-blind round_robin outright on the gated
# memory-pressure cells (observed seed-mean margin +0.13 at worker_mem
# 3 GiB, where round_robin reloads weights on nearly every dispatch); the
# slack is zero — "beats" is the claim, not "roughly matches".
COLDSTART_SLACK = 0.0


@dataclasses.dataclass(frozen=True)
class ClaimResult:
    name: str
    description: str
    passed: bool
    margin: float  # worst-case slack; negative iff the claim failed
    cells: tuple[str, ...]  # per-cell evidence lines

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ClaimResult":
        return cls(
            name=d["name"],
            description=d["description"],
            passed=d["passed"],
            margin=d["margin"],
            cells=tuple(d["cells"]),
        )


def _case_label(spec: ExperimentSpec) -> str:
    """Grouping key for seed averaging.  Includes the load parameters
    (utilization, n_requests) so cells from different sweeps — e.g. a
    combined small-grid + legacy-table result set — are never averaged
    into one mean as if they measured the same experiment.  Engine cells
    carry their substrate in the label for the same reason: a measured
    finish rate and a simulated one are different experiments."""
    params = json.dumps(spec.workload_params, sort_keys=True)
    label = f"{spec.workload}{params}@u{spec.utilization:g}/n{spec.n_requests}"
    if spec.substrate != "sim":
        # Canonicalize: "engine" and "engine:orloj_gpt" are the same
        # experiment and must seed-average together.
        try:
            kind, model = parse_substrate(spec.substrate)
            label += f"/{kind}:{model}"
        except ValueError:  # unknown spelling: keep cells apart, not crash
            label += f"/{spec.substrate}"
    if spec.faults:
        # Defensive: faulted cells are excluded from the paper-claim
        # domains (_eligible), but if one ever reaches a grouping it must
        # not seed-average with fault-free cells of the same case.
        label += "/faults" + json.dumps(spec.faults, sort_keys=True)
    if spec.n_models > 1:
        # Multi-model cells replay a different experiment (Zipf-assigned
        # models, residency stalls) and must never seed-average with
        # single-model cells of the same workload case.
        label += (
            f"/mm{spec.n_models}x{spec.model_skew:g}"
            f"/mem{spec.worker_mem:g}/{spec.residency_policy}"
        )
    return label


def _eligible(r: ExperimentResult) -> bool:
    s = r.spec
    return (
        s.n_workers == 1
        and not s.sched_cfg
        and not s.charge_overhead
        and s.time_scale == 1.0
        and not s.hetero
        # chaos cells (even ones whose plan is disabled) feed the
        # robustness claims only, never the paper orderings
        and not s.faults
        # multi-model cells feed the residency claims only (their finish
        # rates carry cold-start stalls the paper orderings never priced)
        and s.n_models == 1
        and not r.truncated
    )


def _seed_means(
    results: Iterable[ExperimentResult],
) -> dict[tuple[str, str, float, str], float]:
    """(case, family, slo, system) -> finish rate averaged over seeds."""
    acc: dict[tuple, list[float]] = defaultdict(list)
    for r in results:
        if _eligible(r):
            key = (_case_label(r.spec), r.spec.workload, r.spec.slo_scale, r.spec.system)
            acc[key].append(r.finish_rate)
    return {k: sum(v) / len(v) for k, v in acc.items()}


def _fail(name: str, description: str, why: str) -> ClaimResult:
    # Finite sentinel margin: finish-rate margins live in [-1, 1], and
    # -inf would serialize as the non-standard JSON token ``-Infinity``.
    return ClaimResult(name, description, False, -1.0, (why,))


def claim_tight_slo_dominance(
    results: Sequence[ExperimentResult], max_slo: float = TIGHT_SLO_MAX
) -> ClaimResult:
    desc = (
        f"ORLOJ's seed-mean finish rate >= every baseline's on each dynamic "
        f"workload at SLO scale < {max_slo:g}"
    )
    means = _seed_means(results)
    by_cell: dict[tuple[str, float], dict[str, float]] = defaultdict(dict)
    for (case, family, slo, system), fr in means.items():
        if family in DYNAMIC_FAMILIES and slo < max_slo:
            by_cell[(case, slo)][system] = fr
    cells, worst = [], float("inf")
    for (case, slo), per_sys in sorted(by_cell.items()):
        if "orloj" not in per_sys or len(per_sys) < 2:
            continue
        orloj = per_sys["orloj"]
        for system, fr in sorted(per_sys.items()):
            if system == "orloj":
                continue
            margin = orloj - fr
            worst = min(worst, margin)
            cells.append(
                f"{case}@slo{slo:g}: orloj {orloj:.3f} vs {system} {fr:.3f} "
                f"({margin:+.3f})"
            )
    if not cells:
        return _fail(
            "tight-slo-dominance", desc, "no eligible dynamic cells at tight SLO"
        )
    return ClaimResult("tight-slo-dominance", desc, worst >= 0.0, worst, tuple(cells))


def claim_static_parity(
    results: Sequence[ExperimentResult], band: float = STATIC_NOISE_BAND
) -> ClaimResult:
    desc = (
        f"ORLOJ within {band:g} of the best baseline's seed-mean finish rate "
        f"on static workloads"
    )
    means = _seed_means(results)
    by_cell: dict[tuple[str, float], dict[str, float]] = defaultdict(dict)
    for (case, family, slo, system), fr in means.items():
        if family == "static":
            by_cell[(case, slo)][system] = fr
    cells, worst = [], float("inf")
    for (case, slo), per_sys in sorted(by_cell.items()):
        if "orloj" not in per_sys or len(per_sys) < 2:
            continue
        orloj = per_sys["orloj"]
        best_sys, best = max(
            ((s, fr) for s, fr in per_sys.items() if s != "orloj"),
            key=lambda kv: kv[1],
        )
        margin = band + (orloj - best)
        worst = min(worst, margin)
        cells.append(
            f"{case}@slo{slo:g}: orloj {orloj:.3f}, best baseline {best_sys} "
            f"{best:.3f} (gap {orloj - best:+.3f}, band {band:g})"
        )
    if not cells:
        return _fail("static-parity", desc, "no eligible static cells")
    return ClaimResult("static-parity", desc, worst >= 0.0, worst, tuple(cells))


def claim_slo_monotonicity(
    results: Sequence[ExperimentResult], slack: float = MONO_SLACK
) -> ClaimResult:
    desc = (
        f"per system and workload, relaxing the SLO never drops the seed-mean "
        f"finish rate by more than {slack:g}"
    )
    means = _seed_means(results)
    by_series: dict[tuple[str, str], list[tuple[float, float]]] = defaultdict(list)
    for (case, family, slo, system), fr in means.items():
        by_series[(case, system)].append((slo, fr))
    cells, worst = [], float("inf")
    for (case, system), pts in sorted(by_series.items()):
        pts.sort()
        if len(pts) < 2:
            continue
        for (slo_a, fr_a), (slo_b, fr_b) in zip(pts, pts[1:]):
            margin = fr_b - fr_a + slack
            worst = min(worst, margin)
            if margin < 0.0:
                cells.append(
                    f"{case}/{system}: slo{slo_a:g}->{slo_b:g} fell "
                    f"{fr_a:.3f}->{fr_b:.3f} (dip {fr_a - fr_b:.3f} > {slack:g})"
                )
        cells.append(
            f"{case}/{system}: "
            + " -> ".join(f"{fr:.3f}@{slo:g}" for slo, fr in pts)
        )
    if worst == float("inf"):
        return _fail("slo-monotonicity", desc, "no series with >= 2 SLO scales")
    return ClaimResult("slo-monotonicity", desc, worst >= 0.0, worst, tuple(cells))


def _pool_policy_means(
    results: Iterable[ExperimentResult],
) -> dict[tuple, dict[str, float]]:
    """(case, slo, pool) -> {policy: seed-mean finish rate} over *flat*
    pool cells: ORLOJ multi-worker runs with default scheduler config and
    a single pool (fleet cells with ``n_pools > 1`` route through
    hierarchical dispatch, where the policy name means something else —
    they never mix into the flat-dispatch orderings)."""
    acc: dict[tuple, list[float]] = defaultdict(list)
    for r in results:
        s = r.spec
        if (
            s.n_workers > 1
            and s.n_pools == 1
            and s.system == "orloj"
            and not s.sched_cfg
            and not s.charge_overhead
            and s.time_scale == 1.0
            and not s.faults  # chaos cells never feed dispatch orderings
            # multi-model cells compare dispatch under residency stalls —
            # the cold-start-dominance claim's domain, not this one's (a
            # residency-vs-round_robin pair would blow HOMOG_BAND by design)
            and s.n_models == 1
            and not r.truncated
        ):
            pool = f"r{s.n_workers}{'-hetero' if s.hetero else ''}"
            acc[(_case_label(s), s.slo_scale, pool, s.policy)].append(
                r.finish_rate
            )
    means = {k: sum(v) / len(v) for k, v in acc.items()}
    by_cell: dict[tuple, dict[str, float]] = defaultdict(dict)
    for (case, slo, pool, policy), fr in means.items():
        by_cell[(case, slo, pool)][policy] = fr
    return by_cell


def _dispatch_ordering(
    name: str,
    desc: str,
    winner: str,
    by_cell: Mapping[tuple, Mapping[str, float]],
    slack: float,
) -> ClaimResult:
    """Generic per-pool-cell ordering: ``winner``'s seed-mean finish rate
    >= ``round_robin``'s within ``slack``."""
    cells, worst = [], float("inf")
    for (case, slo, pool), per_pol in sorted(by_cell.items()):
        if winner not in per_pol or "round_robin" not in per_pol:
            continue
        win, rr = per_pol[winner], per_pol["round_robin"]
        margin = win - rr + slack
        worst = min(worst, margin)
        cells.append(
            f"{case}@slo{slo:g}/{pool}: {winner} {win:.3f} vs "
            f"round_robin {rr:.3f} ({win - rr:+.3f}, slack {slack:g})"
        )
    if not cells:
        return _fail(
            name, desc, f"no pool cells with both {winner} and round_robin"
        )
    return ClaimResult(name, desc, worst >= 0.0, worst, tuple(cells))


def claim_scaleout_dispatch(
    results: Sequence[ExperimentResult], slack: float = SCALEOUT_SLACK
) -> ClaimResult:
    """§3.1 scale-out ordering: distribution-aware ``jsq_work`` dispatch
    >= ``round_robin`` (within ``slack``) per pool cell, seed-averaged.

    Pool cells are ORLOJ multi-worker runs with default scheduler config;
    homogeneous and heterogeneous pools are separate cells (the claim is
    strongest on hetero pools, where blind rotation overloads the slow
    half)."""
    desc = (
        f"on multi-worker pools, jsq_work dispatch's seed-mean finish rate "
        f">= round_robin's within {slack:g}"
    )
    return _dispatch_ordering(
        "scale-out-dispatch", desc, "jsq_work", _pool_policy_means(results), slack
    )


def claim_p2c_dispatch(
    results: Sequence[ExperimentResult], slack: float = P2C_SLACK
) -> ClaimResult:
    """Two-probe power-of-two-choices dispatch >= ``round_robin`` (within
    ``slack``) per pool cell: two backlog probes per arrival already
    recover the load-aware ordering, which is what makes p2c the fleet
    front-end default (it never scans the whole pool)."""
    desc = (
        f"on multi-worker pools, p2c dispatch's seed-mean finish rate "
        f">= round_robin's within {slack:g}"
    )
    return _dispatch_ordering(
        "p2c-dispatch", desc, "p2c", _pool_policy_means(results), slack
    )


def claim_homog_pool_parity(
    results: Sequence[ExperimentResult], band: float = HOMOG_BAND
) -> ClaimResult:
    """On homogeneous pools every dispatch policy lands within ``band`` of
    the best policy's seed-mean finish rate: identical replicas leave
    load-awareness nothing to exploit, so any larger spread means a
    dispatch policy is broken, not that the workload prefers one."""
    desc = (
        f"on homogeneous pools every dispatch policy's seed-mean finish "
        f"rate is within {band:g} of the best policy's"
    )
    cells, worst = [], float("inf")
    for (case, slo, pool), per_pol in sorted(_pool_policy_means(results).items()):
        if "-hetero" in pool or len(per_pol) < 2:
            continue
        best_pol, best = max(per_pol.items(), key=lambda kv: kv[1])
        for policy, fr in sorted(per_pol.items()):
            if policy == best_pol:
                continue
            margin = band + (fr - best)
            worst = min(worst, margin)
            cells.append(
                f"{case}@slo{slo:g}/{pool}: {policy} {fr:.3f} vs best "
                f"{best_pol} {best:.3f} (gap {fr - best:+.3f}, band {band:g})"
            )
    if not cells:
        return _fail(
            "homog-pool-parity", desc, "no homogeneous pool cells with >= 2 policies"
        )
    return ClaimResult("homog-pool-parity", desc, worst >= 0.0, worst, tuple(cells))


def claim_cluster_wall_budget(
    results: Sequence[ExperimentResult],
) -> ClaimResult:
    """Every wall-budgeted cell replayed inside its budget.  This is the
    fleet grids' performance gate: the budgets are sized from measured
    array-engine replays with generous CI headroom (a 10^5-request,
    100-worker cell runs ~70 s locally against a 300 s budget), so
    breaching one means the event engine regressed, not that the machine
    was slow.  Margin is the worst-case fraction of budget left."""
    desc = "every wall-budgeted cell (wall_budget_s > 0) finishes inside its budget"
    cells, worst = [], float("inf")
    for r in results:
        budget = r.spec.wall_budget_s
        if budget <= 0.0:
            continue
        if r.truncated:
            # The loop cut the replay off AT the budget, so wall_s alone
            # would read as a hairline pass — a truncated budgeted cell
            # is a budget breach by definition.
            worst = min(worst, -1.0)
            cells.append(
                f"{r.spec.tag or _case_label(r.spec)}: TRUNCATED at "
                f"budget {budget:g}s ({r.n_unserved} unserved)"
            )
            continue
        margin = (budget - r.wall_s) / budget
        worst = min(worst, margin)
        cells.append(
            f"{r.spec.tag or _case_label(r.spec)}: wall {r.wall_s:.1f}s / "
            f"budget {budget:g}s ({margin:+.2f} of budget left)"
        )
    if not cells:
        return _fail("cluster-wall-budget", desc, "no wall-budgeted cells")
    return ClaimResult("cluster-wall-budget", desc, worst >= 0.0, worst, tuple(cells))


# Outcome fields two engines must agree on exactly.  Everything here is
# deterministic given the spec (TIMING_FIELDS are excluded by design);
# finish counts are the ISSUE-level contract, makespan/decision counts
# catch divergence that happens to preserve the counts.
_EQUIV_FIELDS = (
    "n_total",
    "n_finished_ok",
    "n_finished_late",
    "n_dropped",
    "n_unserved",
    "n_rejected",
    "n_failed",
    "n_retried",
    "n_decisions",
    "makespan_ms",
    "latency_p99_ms",
    "n_model_loads",
    "n_model_evicts",
    "model_load_ms",
)


def claim_array_scalar_equivalence(
    results: Sequence[ExperimentResult],
) -> ClaimResult:
    """Cells whose specs are identical up to ``engine`` must produce
    identical outcomes — the array engine's anchor to the scalar oracle
    loop.  Margin is the worst-case finish-count discrepancy as a
    fraction of the cell's requests (0.0 when everything matches)."""
    desc = (
        "paired cells identical up to `engine` agree exactly on "
        + ", ".join(_EQUIV_FIELDS)
    )
    by_pair: dict[str, dict[str, ExperimentResult]] = defaultdict(dict)
    for r in results:
        d = r.spec.to_dict()
        engine = d.pop("engine")
        d.pop("tag")
        by_pair[json.dumps(d, sort_keys=True)][engine] = r
    cells, worst = [], float("inf")
    for key, per_engine in sorted(by_pair.items()):
        if len(per_engine) < 2:
            continue
        base_engine, base = sorted(per_engine.items())[0]
        label = base.spec.tag or _case_label(base.spec)
        for engine, r in sorted(per_engine.items()):
            if engine == base_engine:
                continue
            diffs = [
                f"{f}: {getattr(base, f)!r} vs {getattr(r, f)!r}"
                for f in _EQUIV_FIELDS
                if getattr(base, f) != getattr(r, f)
            ]
            count_gap = sum(
                abs(getattr(base, f) - getattr(r, f))
                for f in ("n_finished_ok", "n_finished_late", "n_dropped", "n_unserved")
            ) / max(base.n_total, 1)
            margin = -count_gap if diffs else 0.0
            worst = min(worst, margin)
            if diffs:
                cells.append(
                    f"{label}: {base_engine} != {engine} — " + "; ".join(diffs)
                )
            else:
                cells.append(
                    f"{label}: {base_engine} == {engine} "
                    f"({base.n_finished_ok}+{base.n_finished_late} finished)"
                )
    if not cells:
        return _fail(
            "array-scalar-equivalence", desc, "no spec paired across engines"
        )
    return ClaimResult(
        "array-scalar-equivalence", desc, worst >= 0.0, worst, tuple(cells)
    )


# Outcome fields a disabled fault plan must leave bitwise unchanged
# relative to running with no plan at all (the noop contract covers the
# per-state counts and the rate/latency aggregates derived from them).
_NOOP_FIELDS = _EQUIV_FIELDS + (
    "finish_rate",
    "utilization",
    "latency_p50_ms",
)


def _noop_groups(
    results: Sequence[ExperimentResult],
) -> dict[str, dict[str, ExperimentResult]]:
    """Group cells identical up to (faults, tag); within each group keep
    the bare cell (no faults dict) and every *disabled*-plan variant.
    Cells with active plans never enter (they are supposed to differ)."""
    groups: dict[str, dict[str, ExperimentResult]] = defaultdict(dict)
    for r in results:
        f = r.spec.faults
        if f and FaultPlan.from_dict(f).enabled():
            continue
        d = r.spec.to_dict()
        d.pop("tag")
        faults = d.pop("faults")
        variant = "bare" if not faults else "disabled:" + json.dumps(
            faults, sort_keys=True
        )
        groups[json.dumps(d, sort_keys=True)][variant] = r
    return groups


def claim_fault_free_noop(
    results: Sequence[ExperimentResult],
) -> ClaimResult:
    """Threading a *disabled* :class:`FaultPlan` through the engine hooks
    changes nothing observable: cells identical up to the faults dict —
    one with no plan at all, one with every knob off — agree bitwise on
    every outcome field.  This is what licenses keeping the fault hooks
    in the hot loop: with no plan (or a disabled one) the pre-existing
    grid outcomes are unchanged."""
    desc = (
        "cells identical up to a *disabled* faults dict agree exactly on "
        + ", ".join(_NOOP_FIELDS)
    )
    cells, worst = [], float("inf")
    for key, variants in sorted(_noop_groups(results).items()):
        if "bare" not in variants or len(variants) < 2:
            continue
        base = variants["bare"]
        label = base.spec.tag or _case_label(base.spec)
        for variant, r in sorted(variants.items()):
            if variant == "bare":
                continue
            diffs = [
                f"{f}: {getattr(base, f)!r} vs {getattr(r, f)!r}"
                for f in _NOOP_FIELDS
                if getattr(base, f) != getattr(r, f)
            ]
            margin = -1.0 if diffs else 0.0
            worst = min(worst, margin)
            if diffs:
                cells.append(f"{label}: bare != {variant} — " + "; ".join(diffs))
            else:
                cells.append(
                    f"{label}: disabled plan is a noop "
                    f"({base.n_finished_ok}+{base.n_finished_late} finished)"
                )
    if not cells:
        return _fail(
            "fault-free-noop", desc, "no cell paired bare vs disabled-plan"
        )
    return ClaimResult("fault-free-noop", desc, worst >= 0.0, worst, tuple(cells))


def _severity_series(
    results: Sequence[ExperimentResult],
) -> dict[tuple[str, float], dict[str, list[tuple[float, float]]]]:
    """(case-sans-faults, slo) -> system -> [(severity-sorted mttf level,
    seed-mean finish rate)] over the chaos degradation cells (flat pools,
    default config, non-truncated).  Severity orders levels from
    fault-free (mttf 0, disabled plan) to harshest (smallest mttf)."""
    acc: dict[tuple, list[float]] = defaultdict(list)
    for r in results:
        s = r.spec
        if (
            not s.faults
            or r.truncated
            or s.n_pools != 1
            or s.sched_cfg
            or s.charge_overhead
            or s.time_scale != 1.0
        ):
            continue
        plan = FaultPlan.from_dict(s.faults)
        if plan.enabled() and plan.mttf_ms <= 0.0:
            continue  # not a crash-severity cell (timeout/straggler-only)
        base = dict(s.to_dict())
        base.pop("tag")
        base.pop("faults")  # the level is identified by the plan's mttf
        base.pop("seed")
        base.pop("engine", None)
        key = (
            json.dumps(base | {"system": ""}, sort_keys=True),
            s.slo_scale,
            s.system,
            plan.mttf_ms,
        )
        acc[key].append(r.finish_rate)
    series: dict[tuple[str, float], dict[str, list[tuple[float, float]]]] = (
        defaultdict(lambda: defaultdict(list))
    )
    for (case, slo, system, mttf), rates in acc.items():
        series[(case, slo)][system].append((mttf, sum(rates) / len(rates)))
    for per_sys in series.values():
        for pts in per_sys.values():
            # fault-free (mttf 0) first, then descending MTTF = rising severity
            pts.sort(key=lambda p: (0, 0.0) if p[0] == 0.0 else (1, -p[0]))
    return series


def claim_graceful_degradation(
    results: Sequence[ExperimentResult],
    rise_slack: float = FAULT_RISE_SLACK,
    cliff: float = FAULT_CLIFF,
    dominance_slack: float = FAULT_DOMINANCE_SLACK,
) -> ClaimResult:
    """Crash severity degrades finish rates *gracefully*: per system the
    seed-mean finish rate falls (within ``rise_slack``) as MTTF shrinks,
    never by more than ``cliff`` between adjacent levels, and ORLOJ stays
    within ``dominance_slack`` of the top at every level (crashes must
    not invert the paper's ordering)."""
    desc = (
        f"per system, finish rate under rising crash severity is monotone "
        f"(within {rise_slack:g}) with no adjacent-level drop > {cliff:g}, "
        f"and orloj >= every baseline - {dominance_slack:g} at each level"
    )
    cells, worst = [], float("inf")
    for (case, slo), per_sys in sorted(_severity_series(results).items()):
        for system, pts in sorted(per_sys.items()):
            if len(pts) < 2:
                continue
            for (m_a, fr_a), (m_b, fr_b) in zip(pts, pts[1:]):
                lvl = f"mttf{m_a:g}->mttf{m_b:g}"
                rise_margin = rise_slack - (fr_b - fr_a)
                cliff_margin = cliff - (fr_a - fr_b)
                worst = min(worst, rise_margin, cliff_margin)
                if rise_margin < 0.0 or cliff_margin < 0.0:
                    cells.append(
                        f"slo{slo:g}/{system} {lvl}: {fr_a:.3f}->{fr_b:.3f} "
                        f"(rise margin {rise_margin:+.3f}, "
                        f"cliff margin {cliff_margin:+.3f})"
                    )
            cells.append(
                f"slo{slo:g}/{system}: "
                + " -> ".join(f"{fr:.3f}@mttf{m:g}" for m, fr in pts)
            )
        if "orloj" in per_sys:
            orloj_by_lvl = dict(per_sys["orloj"])
            for system, pts in sorted(per_sys.items()):
                if system == "orloj":
                    continue
                for m, fr in pts:
                    if m not in orloj_by_lvl:
                        continue
                    margin = orloj_by_lvl[m] - fr + dominance_slack
                    worst = min(worst, margin)
                    if margin < 0.0:
                        cells.append(
                            f"slo{slo:g}@mttf{m:g}: orloj "
                            f"{orloj_by_lvl[m]:.3f} < {system} {fr:.3f} "
                            f"- slack ({margin:+.3f})"
                        )
    if worst == float("inf"):
        return _fail(
            "graceful-degradation", desc, "no crash-severity series with >= 2 levels"
        )
    return ClaimResult(
        "graceful-degradation", desc, worst >= 0.0, worst, tuple(cells)
    )


def claim_token_length_awareness(
    results: Sequence[ExperimentResult], max_slo: float = TOKEN_TIGHT_SLO_MAX
) -> ClaimResult:
    """Token-mode ordering (DESIGN.md §12): under tight TPOT SLOs,
    admission driven by the learned output-length distributions
    (``token_orloj``: shortest-expected-first with per-step conditional
    remaining-length feasibility and early dropping) finishes at least as
    many requests as length-blind FCFS continuous batching
    (``token_fcfs``) — strict, no tolerance, per token case and tight
    scale, seed-averaged.  The token-mode analogue of
    ``tight-slo-dominance``: knowing the length distribution is what buys
    predictability when per-request work is hidden until EOS."""
    desc = (
        f"token_orloj's seed-mean finish rate >= token_fcfs's on each "
        f"tokens case at TPOT scale < {max_slo:g}"
    )
    means = _seed_means(results)
    by_cell: dict[tuple[str, float], dict[str, float]] = defaultdict(dict)
    for (case, family, slo, system), fr in means.items():
        if family == "tokens" and slo < max_slo:
            by_cell[(case, slo)][system] = fr
    cells, worst = [], float("inf")
    for (case, slo), per_sys in sorted(by_cell.items()):
        if "token_orloj" not in per_sys or "token_fcfs" not in per_sys:
            continue
        aware, blind = per_sys["token_orloj"], per_sys["token_fcfs"]
        margin = aware - blind
        worst = min(worst, margin)
        cells.append(
            f"{case}@slo{slo:g}: token_orloj {aware:.3f} vs token_fcfs "
            f"{blind:.3f} ({margin:+.3f})"
        )
    if not cells:
        return _fail(
            "token-length-awareness",
            desc,
            "no tokens cells pairing token_orloj with token_fcfs at tight TPOT",
        )
    return ClaimResult(
        "token-length-awareness", desc, worst >= 0.0, worst, tuple(cells)
    )


def claim_nexus_slo2_gap(
    results: Sequence[ExperimentResult],
    window: tuple[float, float] = NEXUS_SLO2_WINDOW,
    bound: float = NEXUS_SLO2_BOUND,
) -> ClaimResult:
    """The intermediate-SLO regime is *bounded*, not ordered: at SLO
    scales in ``window`` Nexus's fixed-batch plan is genuinely
    competitive in this repro (DESIGN.md §7 — ORLOJ's probabilistic
    early dropping sheds a few requests Nexus goes on to finish), and
    this claim caps the seed-mean gap at ``bound`` so a regression that
    *widens* the regime still fails CI."""
    lo, hi = window
    desc = (
        f"seed-mean nexus-over-orloj finish-rate gap <= {bound:g} at SLO "
        f"scales in [{lo:g}, {hi:g}]"
    )
    means = _seed_means(results)
    by_cell: dict[tuple[str, float], dict[str, float]] = defaultdict(dict)
    for (case, family, slo, system), fr in means.items():
        if family in DYNAMIC_FAMILIES and lo <= slo <= hi:
            by_cell[(case, slo)][system] = fr
    cells, worst = [], float("inf")
    for (case, slo), per_sys in sorted(by_cell.items()):
        if "orloj" not in per_sys or "nexus" not in per_sys:
            continue
        gap = per_sys["nexus"] - per_sys["orloj"]
        margin = bound - gap
        worst = min(worst, margin)
        cells.append(
            f"{case}@slo{slo:g}: nexus {per_sys['nexus']:.3f} vs orloj "
            f"{per_sys['orloj']:.3f} (gap {gap:+.3f}, bound {bound:g})"
        )
    if not cells:
        return _fail(
            "nexus-slo2-gap", desc, "no orloj/nexus pairs in the SLO window"
        )
    return ClaimResult("nexus-slo2-gap", desc, worst >= 0.0, worst, tuple(cells))


# Multi-model spec knobs that must be observably inert at n_models == 1
# (no residency plan is built, no model assignment happens), plus their
# defaults — the single-model-noop pairing key.
_MM_KNOB_DEFAULTS = {
    "n_models": 1,
    "model_skew": 1.1,
    "worker_mem": 0.0,
    "residency_policy": "lru",
}


def _mm_noop_groups(
    results: Sequence[ExperimentResult],
) -> dict[str, dict[str, ExperimentResult]]:
    """Group ``n_models == 1`` cells identical up to (multi-model knobs,
    tag); within each group keep the all-defaults cell ("bare") and every
    knobs-set-but-inert variant.  Cells with ``n_models > 1`` never enter
    (they are supposed to differ)."""
    groups: dict[str, dict[str, ExperimentResult]] = defaultdict(dict)
    for r in results:
        if r.spec.n_models != 1:
            continue
        d = r.spec.to_dict()
        d.pop("tag")
        knobs = {k: d.pop(k) for k in _MM_KNOB_DEFAULTS}
        variant = (
            "bare"
            if knobs == _MM_KNOB_DEFAULTS
            else "inert:" + json.dumps(knobs, sort_keys=True)
        )
        groups[json.dumps(d, sort_keys=True)][variant] = r
    return groups


def claim_single_model_noop(
    results: Sequence[ExperimentResult],
) -> ClaimResult:
    """The multi-model tier is completely inert at ``n_models == 1``:
    cells identical up to the multi-model knobs — one with every knob at
    its default, one with skew/memory/policy set but n_models still 1 —
    agree bitwise on every outcome field (and their residency counters
    are zero).  This is what licenses threading the residency hooks
    through the event engines: every pre-multi-model grid cell replays
    unchanged (DESIGN.md §13)."""
    desc = (
        "n_models=1 cells identical up to the multi-model knobs agree "
        "exactly on " + ", ".join(_NOOP_FIELDS)
    )
    cells, worst = [], float("inf")
    for key, variants in sorted(_mm_noop_groups(results).items()):
        if "bare" not in variants or len(variants) < 2:
            continue
        base = variants["bare"]
        label = base.spec.tag or _case_label(base.spec)
        for variant, r in sorted(variants.items()):
            if variant == "bare":
                continue
            diffs = [
                f"{f}: {getattr(base, f)!r} vs {getattr(r, f)!r}"
                for f in _NOOP_FIELDS
                if getattr(base, f) != getattr(r, f)
            ]
            if base.n_model_loads or r.n_model_loads:
                diffs.append(
                    f"n_model_loads nonzero: {base.n_model_loads} / "
                    f"{r.n_model_loads}"
                )
            margin = -1.0 if diffs else 0.0
            worst = min(worst, margin)
            if diffs:
                cells.append(f"{label}: bare != {variant} — " + "; ".join(diffs))
            else:
                cells.append(
                    f"{label}: multi-model knobs are a noop at n_models=1 "
                    f"({base.n_finished_ok}+{base.n_finished_late} finished)"
                )
    if not cells:
        return _fail(
            "single-model-noop", desc, "no cell paired bare vs inert-knobs"
        )
    return ClaimResult("single-model-noop", desc, worst >= 0.0, worst, tuple(cells))


def _mm_policy_means(
    results: Iterable[ExperimentResult],
) -> dict[tuple, dict[str, float]]:
    """(case, slo, pool) -> {policy: seed-mean finish rate} over the
    multi-model pool cells (``n_models > 1``, flat orloj pools, default
    scheduler config) — the cold-start-dominance domain.  The case label
    carries the multi-model knobs, so cells at different memory budgets
    or eviction policies are never averaged together."""
    acc: dict[tuple, list[float]] = defaultdict(list)
    for r in results:
        s = r.spec
        if (
            s.n_models > 1
            and s.n_workers > 1
            and s.n_pools == 1
            and s.system == "orloj"
            and not s.sched_cfg
            and not s.charge_overhead
            and s.time_scale == 1.0
            and not s.faults
            and not r.truncated
        ):
            pool = f"r{s.n_workers}{'-hetero' if s.hetero else ''}"
            acc[(_case_label(s), s.slo_scale, pool, s.policy)].append(
                r.finish_rate
            )
    means = {k: sum(v) / len(v) for k, v in acc.items()}
    by_cell: dict[tuple, dict[str, float]] = defaultdict(dict)
    for (case, slo, pool, policy), fr in means.items():
        by_cell[(case, slo, pool)][policy] = fr
    return by_cell


def claim_cold_start_dominance(
    results: Sequence[ExperimentResult], slack: float = COLDSTART_SLACK
) -> ClaimResult:
    """Multi-model ordering (DESIGN.md §13): under memory pressure,
    residency-aware dispatch (place on a worker already holding the
    model's weights, falling back to least backlog) finishes at least as
    many requests as residency-blind ``round_robin``, which pays a PCIe
    weight load on nearly every dispatch — per multi-model pool cell,
    seed-averaged.  The multi-model analogue of ``tight-slo-dominance``:
    knowing where the weights live is what buys predictability when a
    cold start costs hundreds of milliseconds."""
    desc = (
        f"on multi-model pools under memory pressure, residency dispatch's "
        f"seed-mean finish rate >= round_robin's within {slack:g}"
    )
    return _dispatch_ordering(
        "cold-start-dominance", desc, "residency", _mm_policy_means(results), slack
    )


def evaluate_claims(
    results: Sequence[ExperimentResult],
    *,
    tight_slo_max: float = TIGHT_SLO_MAX,
    static_band: float = STATIC_NOISE_BAND,
    mono_slack: float = MONO_SLACK,
    scaleout_slack: float = SCALEOUT_SLACK,
    p2c_slack: float = P2C_SLACK,
    homog_band: float = HOMOG_BAND,
) -> list[ClaimResult]:
    """Assemble the claim set a result set can actually support.  Each
    claim is *stated* only when its domain is populated — the fleet-scale
    ``cluster`` grids contain no single-worker conformance cells, and the
    paper grids contain no wall-budgeted ones; a grid is never failed on
    a claim it was not designed to exercise.  Within a stated claim an
    empty domain still fails (that is a broken grid, not a missing one).

    Truncated cells (``wall_budget_s`` overrun) are *skipped* by every
    outcome claim — their stats are partial — and reported through
    ``cluster-wall-budget``, which fails them outright."""
    live = [r for r in results if not r.truncated]
    claims = []
    # The paper claims need single-worker default-config cells; each is
    # stated only when *its own* domain is populated, so a focused
    # diagnostic grid (e.g. slo2-bimodal, all-dynamic at intermediate
    # scales) is not failed on claims whose cells it never carried.
    eligible = [r for r in results if _eligible(r)]
    if any(
        r.spec.workload in DYNAMIC_FAMILIES and r.spec.slo_scale < tight_slo_max
        for r in eligible
    ):
        claims.append(claim_tight_slo_dominance(results, tight_slo_max))
    if any(r.spec.workload == "static" for r in eligible):
        claims.append(claim_static_parity(results, static_band))
    slos_per_series: dict[tuple, set] = defaultdict(set)
    for r in eligible:
        slos_per_series[(_case_label(r.spec), r.spec.system)].add(
            r.spec.slo_scale
        )
    if any(len(s) >= 2 for s in slos_per_series.values()):
        claims.append(claim_slo_monotonicity(results, mono_slack))
    # The intermediate-SLO bounding claim (slo2-bimodal grid): stated
    # whenever eligible orloj/nexus pairs land inside the window.
    lo, hi = NEXUS_SLO2_WINDOW
    slo2_systems: dict[tuple, set] = defaultdict(set)
    for r in results:
        if _eligible(r) and lo <= r.spec.slo_scale <= hi:
            slo2_systems[(_case_label(r.spec), r.spec.slo_scale)].add(
                r.spec.system
            )
    if any({"orloj", "nexus"} <= s for s in slo2_systems.values()):
        claims.append(claim_nexus_slo2_gap(results))
    # Token-mode ordering (tokens grids): stated when eligible tight-TPOT
    # cells pair the length-aware scheduler with length-blind FCFS.
    token_systems: dict[tuple, set] = defaultdict(set)
    for r in eligible:
        if r.spec.workload == "tokens" and r.spec.slo_scale < TOKEN_TIGHT_SLO_MAX:
            token_systems[(_case_label(r.spec), r.spec.slo_scale)].add(
                r.spec.system
            )
    if any({"token_orloj", "token_fcfs"} <= s for s in token_systems.values()):
        claims.append(claim_token_length_awareness(results))
    # Dispatch-ordering claims need flat pool cells with the compared
    # policies; grids without them (tiny, the legacy table sweeps, the
    # fleet grids) simply don't state them rather than failing on
    # "no cells".
    pool_means = _pool_policy_means(live)
    pool_policies = {p for per_pol in pool_means.values() for p in per_pol}
    if {"jsq_work", "round_robin"} <= pool_policies:
        claims.append(claim_scaleout_dispatch(live, scaleout_slack))
    if {"p2c", "round_robin"} <= pool_policies:
        claims.append(claim_p2c_dispatch(live, p2c_slack))
    if any(
        "-hetero" not in pool and len(per_pol) >= 2
        for (_case, _slo, pool), per_pol in pool_means.items()
    ):
        claims.append(claim_homog_pool_parity(live, homog_band))
    # Fleet-grid gates: wall budgets and scalar/array outcome equivalence.
    # The budget claim alone sees truncated cells (and fails them).
    if any(r.spec.wall_budget_s > 0.0 for r in results):
        claims.append(claim_cluster_wall_budget(results))
    engines_by_pair: dict[str, set] = defaultdict(set)
    for r in live:
        d = r.spec.to_dict()
        engine = d.pop("engine")
        d.pop("tag")
        engines_by_pair[json.dumps(d, sort_keys=True)].add(engine)
    if any(len(e) >= 2 for e in engines_by_pair.values()):
        claims.append(claim_array_scalar_equivalence(live))
    # Chaos-grid gates: the disabled-plan noop contract and the crash
    # severity ladder (DESIGN.md §11).
    if any(
        "bare" in v and len(v) >= 2 for v in _noop_groups(live).values()
    ):
        claims.append(claim_fault_free_noop(live))
    # Multi-model gates (DESIGN.md §13): the inert-knobs noop contract
    # and the residency-vs-blind dispatch ordering under memory pressure.
    if any(
        "bare" in v and len(v) >= 2 for v in _mm_noop_groups(live).values()
    ):
        claims.append(claim_single_model_noop(live))
    if any(
        {"residency", "round_robin"} <= set(per_pol)
        for per_pol in _mm_policy_means(live).values()
    ):
        claims.append(claim_cold_start_dominance(live))
    if any(
        len(pts) >= 2
        for per_sys in _severity_series(live).values()
        for pts in per_sys.values()
    ):
        claims.append(claim_graceful_degradation(live))
    return claims


def format_report(claims: Sequence[ClaimResult], verbose: bool = False) -> str:
    lines = []
    for c in claims:
        status = "PASS" if c.passed else "FAIL"
        lines.append(f"[{status}] {c.name} (worst margin {c.margin:+.3f})")
        lines.append(f"       {c.description}")
        # Evidence lines: always on failure, on request otherwise.
        if verbose or not c.passed:
            for cell in c.cells:
                lines.append(f"         {cell}")
    ok = all(c.passed for c in claims)
    lines.append(f"conformance: {'PASS' if ok else 'FAIL'} "
                 f"({sum(c.passed for c in claims)}/{len(claims)} claims)")
    return "\n".join(lines)
