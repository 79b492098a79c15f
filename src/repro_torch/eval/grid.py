"""Experiment grids: the conformance grids (``tiny``/``small``/``full``/
``engine-smoke``) plus spec constructors for every legacy ``benchmarks/``
table and figure.

This is stage 1 of the grid-cell lifecycle (spec → seeded RequestSet →
result → claim, see :mod:`repro.eval.spec`): a grid is nothing but a list
of :class:`ExperimentSpec` values; everything downstream — request
generation, replay, claims — is derived from them.

The conformance grids cross {workload case} x {SLO scale} x {seed} x
{system} and are what the claims layer (:mod:`repro.eval.claims`)
evaluates.  SLO scales are chosen where the repro's orderings are
*reproducible*: tight scales (1.25, 1.5) for the dominance claim and a
loose anchor (3.0) for the monotonicity claim.  Intermediate scales
(≈2×P99) are deliberately absent from the gated grids — there Nexus's
fixed-batch plan is genuinely competitive in this repro and the gate does
not assert an ordering the code does not reproduce (see DESIGN.md §7).
The small grid also carries a handful of heterogeneous pool cells feeding
the scale-out dispatch claim (§3.1: jsq_work >= round_robin).

``engine-smoke`` is the real-substrate tier: a few tiny
``substrate="engine"`` cells that drive the actual JAX model through the
same lifecycle (DESIGN.md §8).  It is tracked, not gated — engine finish
rates are real measurements and CI-runner timing variance is not yet
characterized.

The ``tableN``/``figN``/``cluster`` constructors mirror the historical
benchmark sweeps cell-for-cell; ``benchmarks/*.py`` are thin formatters
over them.
"""

from __future__ import annotations

from typing import Sequence

from .spec import ExperimentSpec

__all__ = ["GRIDS", "SYSTEMS", "tiny", "small", "full", "engine_smoke"]

# Every compared system, ORLOJ first (the paper's Tables 2-5 set plus the
# EDF ablation from core/baselines.py).
SYSTEMS = ("orloj", "clockwork", "nexus", "clipper", "edf")

# name -> (family, params, utilization) of the gated workload cases.
_SMALL_CASES = (
    ("bimodal", "bimodal", {"std": 1.0}, 0.85),
    ("3-modal", "k_modal", {"k": 3}, 0.85),
    ("static", "static", {"mean": 12.0}, 0.7),
)
_SMALL_SLOS = (1.25, 1.5, 3.0)
_SMALL_SEEDS = (7, 11, 23, 31, 43)


def _conformance(
    cases: Sequence[tuple[str, str, dict, float]],
    slos: Sequence[float],
    seeds: Sequence[int],
    n_requests: int,
    systems: Sequence[str] = SYSTEMS,
) -> list[ExperimentSpec]:
    return [
        ExperimentSpec(
            workload=family,
            workload_params=dict(params),
            slo_scale=slo,
            utilization=util,
            n_requests=n_requests,
            seed=seed,
            system=system,
            tag=f"eval/{case}/slo{slo:g}/{system}/s{seed}",
        )
        for case, family, params, util in cases
        for slo in slos
        for seed in seeds
        for system in systems
    ]


def tiny() -> list[ExperimentSpec]:
    """8 cells in seconds — CLI smoke and unit tests, not gate-worthy."""
    return _conformance(
        _SMALL_CASES[:1] + _SMALL_CASES[2:],
        slos=(1.25, 3.0),
        seeds=(7,),
        n_requests=120,
        systems=("orloj", "nexus"),
    )


def _scaleout_cells() -> list[ExperimentSpec]:
    """Pool cells feeding the scale-out dispatch claims: a 4-replica pool
    under each compared front-end policy, heterogeneous (half the replicas
    2x slower; offered load 0.8 x the 3 fast-worker-equivalent capacity)
    AND homogeneous (offered load 0.8 x 4 capacities).  ``round_robin``
    and ``jsq_work`` are the original PR-5 cells (their specs are
    unchanged — the bitwise grid contract covers them); ``p2c`` rides the
    same traces and feeds the p2c-dispatch claim, and the homogeneous
    pool feeds homog-pool-parity (DESIGN.md §7 carry-over, now asserted
    since fleet mode exercises both at scale)."""
    hetero_cells = [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=3.0,
            utilization=0.8 * 3,
            n_requests=500,
            seed=seed,
            system="orloj",
            n_workers=4,
            policy=policy,
            hetero=True,
            tag=f"eval/pool-hetero/{policy}/s{seed}",
        )
        for policy in ("round_robin", "jsq_work", "p2c")
        for seed in (7, 11, 23)
    ]
    homog_cells = [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=3.0,
            utilization=0.8 * 4,
            n_requests=500,
            seed=seed,
            system="orloj",
            n_workers=4,
            policy=policy,
            tag=f"eval/pool-homog/{policy}/s{seed}",
        )
        for policy in ("round_robin", "jsq_work", "p2c")
        for seed in (7, 11, 23)
    ]
    return hetero_cells + homog_cells


def small() -> list[ExperimentSpec]:
    """The CI conformance grid: 3 cases x 3 SLOs x 5 seeds x 5 systems at
    n=300 (~1 min serial), plus the scale-out pool cells and the
    token-mode conformance cells (:func:`tokens` — the
    token-length-awareness claim rides in the same acceptance artifact).
    This is the grid the acceptance gate runs on."""
    return (
        _conformance(_SMALL_CASES, _SMALL_SLOS, _SMALL_SEEDS, n_requests=300)
        + _scaleout_cells()
        + tokens()
    )


_FULL_CASES = (
    ("bimodal-std0.5", "bimodal", {"std": 0.5}, 0.85),
    ("bimodal", "bimodal", {"std": 1.0}, 0.85),
    ("bimodal-std2", "bimodal", {"std": 2.0}, 0.85),
    ("bimodal-std2/0.5", "bimodal", {"std": [2.0, 0.5]}, 0.85),
    ("bimodal-std0.5/2", "bimodal", {"std": [0.5, 2.0]}, 0.85),
    ("2-modal", "k_modal", {"k": 2}, 0.85),
    ("3-modal", "k_modal", {"k": 3}, 0.85),
    ("5-modal", "k_modal", {"k": 5}, 0.85),
    ("8-modal", "k_modal", {"k": 8}, 0.85),
    ("more-short", "unequal_bimodal", {"more": "short"}, 0.85),
    ("more-long", "unequal_bimodal", {"more": "long"}, 0.85),
    ("inception", "static", {"mean": 12.0}, 0.7),
    ("resnet", "static", {"mean": 7.0}, 0.7),
    ("gpt-cornell", "real", {"name": "gpt-cornell"}, 0.85),
    ("bart-cnn", "real", {"name": "bart-cnn"}, 0.85),
)


def full() -> list[ExperimentSpec]:
    """Paper-scale sweep (~900 cells at n=1200; use ``--jobs``)."""
    return _conformance(
        _FULL_CASES, slos=(1.25, 1.5, 3.0, 5.0), seeds=(7, 11, 23), n_requests=1200
    )


def engine_smoke() -> list[ExperimentSpec]:
    """The real-substrate tier: 4 tiny ``substrate="engine"`` cells that
    serve the bimodal case through the toy ``orloj_gpt`` JAX model —
    ORLOJ vs Nexus at a tight and a loose SLO.  Minutes on CPU (model
    init + per-shape XLA compilation dominate; the cells themselves are
    cheap).  Tracked, not gated: see DESIGN.md §8."""
    return [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=slo,
            utilization=0.6,
            n_requests=48,
            seed=7,
            system=system,
            substrate="engine",
            tag=f"engine/bimodal/slo{slo:g}/{system}/s7",
        )
        for slo in (1.5, 5.0)
        for system in ("orloj", "nexus")
    ]


# --------------------------------------------------------------------------
# Fleet-scale cluster grids (DESIGN.md §10): 10^5-request traces over
# 10^2–10^3 workers, dispatched hierarchically (front-end p2c/jsq_work
# between pools, a flat policy within each) on the array engine.


def _fleet_cell(
    n_workers: int,
    n_pools: int,
    inter: str,
    *,
    budget_s: float,
    n_requests: int = 100_000,
    engine: str = "array",
    seed: int = 13,
) -> ExperimentSpec:
    return ExperimentSpec(
        workload="bimodal",
        workload_params={"std": 1.0},
        slo_scale=3.0,
        utilization=0.8 * n_workers,
        n_requests=n_requests,
        seed=seed,
        system="orloj",
        n_workers=n_workers,
        policy=inter,
        n_pools=n_pools,
        intra_policy="round_robin",
        engine=engine,
        tick_ms=4.0,
        wall_budget_s=budget_s,
        loop_seed=0,
        tag=f"cluster/fleet-w{n_workers}p{n_pools}/{inter}/{engine}",
    )


def _fleet_equiv_cells(inters: Sequence[str] = ("p2c", "jsq_work")) -> list[ExperimentSpec]:
    """Scalar/array paired fleet cells at small scale: identical specs up
    to ``engine``, feeding the array-scalar-equivalence claim (the fleet
    grids' correctness contract — finish counts must match exactly)."""
    return [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=3.0,
            utilization=0.8 * 16,
            n_requests=2_000,
            seed=13,
            system="orloj",
            n_workers=16,
            policy=inter,
            n_pools=4,
            intra_policy="round_robin",
            engine=engine,
            tick_ms=4.0,
            loop_seed=0,
            tag=f"cluster/equiv-w16p4/{inter}/{engine}",
        )
        for inter in inters
        for engine in ("scalar", "array")
    ]


def cluster_fleet() -> list[ExperimentSpec]:
    """The fleet grid: 10^5-request hierarchical-dispatch cells at 100 and
    1000 workers (array engine, tick-quantized arrivals), wall-budgeted,
    plus the scalar/array equivalence pairs at small scale.  Gated on
    budget + equivalence (claims ``cluster-wall-budget`` and
    ``array-scalar-equivalence``); finish rates are tracked evidence."""
    return [
        _fleet_cell(100, 10, "p2c", budget_s=300.0),
        _fleet_cell(100, 10, "jsq_work", budget_s=300.0),
        _fleet_cell(1000, 32, "p2c", budget_s=600.0),
    ] + _fleet_equiv_cells()


def cluster_smoke() -> list[ExperimentSpec]:
    """Trimmed CI tier of :func:`cluster_fleet`: one 10^5-request
    100-worker cell under its wall budget plus one scalar/array
    equivalence pair (~2 min locally)."""
    return [_fleet_cell(100, 10, "p2c", budget_s=300.0)] + _fleet_equiv_cells(
        inters=("p2c",)
    )


# --------------------------------------------------------------------------
# Chaos grids (DESIGN.md §11): seeded fault injection over the same
# lifecycle.  Every chaos cell carries a ``faults`` dict — even the
# fault-free anchors, whose plans are *disabled* (every knob off) — so
# the whole family is excluded from the paper-claim domains by
# construction (claims._eligible filters on ``spec.faults``) and feeds
# only the robustness claims ``fault-free-noop``, ``graceful-degradation``
# and the fault-extended ``array-scalar-equivalence``.

# Nominal virtual makespan of the 2-worker degradation cell (measured
# ~36 s); the MTTF severity ladder is expressed in units of it.
_CHAOS_SPAN_MS = 36_000.0
# level name -> MTTF in units of _CHAOS_SPAN_MS (0 = crashes off).
_CHAOS_LEVELS = (("off", 0.0), ("mild", 2.0), ("moderate", 0.5), ("severe", 0.15))


def _chaos_plan(level_x: float, seed: int, **extra) -> dict:
    """The degradation sweep's fault dict at one severity level.  At
    ``level_x == 0`` the crash/straggler knobs are off but the dict is
    still populated — a *disabled* plan that threads the hooks (the
    fault-free-noop domain)."""
    on = level_x > 0.0
    return dict(
        seed=101 + seed,
        mttf_ms=level_x * _CHAOS_SPAN_MS,
        restart_delay_ms=250.0 if on else 0.0,
        max_retries=3,
        retry_backoff_ms=10.0,
        retry_threshold=0.05,
        straggler_prob=0.05 if on else 0.0,
        straggler_factor=2.5 if on else 1.0,
        **extra,
    )


def _chaos_noop_twins(seeds: Sequence[int]) -> list[ExperimentSpec]:
    """Paired cells per (engine, seed): identical specs except one has no
    faults dict at all and the other a populated-but-*disabled* plan.
    The fault-free-noop claim asserts each pair is bitwise identical —
    i.e. threading the fault hooks costs nothing observable."""
    base = dict(
        workload="bimodal",
        workload_params={"std": 1.0},
        slo_scale=1.5,
        utilization=0.85 * 2,
        n_requests=300,
        n_workers=2,
        policy="round_robin",
    )
    return [
        ExperimentSpec(
            **base,
            seed=seed,
            engine=engine,
            faults=faults,
            tag=f"chaos/noop-{variant}/{engine}/s{seed}",
        )
        for seed in seeds
        for engine in ("scalar", "array")
        for variant, faults in (
            ("bare", {}),
            ("disabled", _chaos_plan(0.0, seed)),
        )
    ]


def _chaos_equiv_cells(fleet: bool = True) -> list[ExperimentSpec]:
    """Scalar/array twins under *active* plans (crashes + stragglers +
    admission), extending the array-scalar-equivalence claim to the
    fault tier; optionally one fleet pair so requeue re-dispatch across
    pool boundaries is covered too."""
    active = _chaos_plan(0.5, 13, admission_floor=0.05)
    cells = [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=1.5,
            utilization=0.85 * 4,
            n_requests=500,
            seed=13,
            system="orloj",
            n_workers=4,
            policy="least_loaded",
            engine=engine,
            faults=dict(active),
            tag=f"chaos/equiv-w4/{engine}",
        )
        for engine in ("scalar", "array")
    ]
    if fleet:
        cells += [
            ExperimentSpec(
                workload="bimodal",
                workload_params={"std": 1.0},
                slo_scale=1.5,
                utilization=0.85 * 6,
                n_requests=500,
                seed=13,
                system="orloj",
                n_workers=6,
                policy="p2c",
                n_pools=2,
                intra_policy="round_robin",
                engine=engine,
                loop_seed=0,
                faults=dict(active),
                tag=f"chaos/equiv-fleet-w6p2/{engine}",
            )
            for engine in ("scalar", "array")
        ]
    return cells


def _chaos_degradation(
    seeds: Sequence[int], systems: Sequence[str] = SYSTEMS
) -> list[ExperimentSpec]:
    """The severity ladder: every compared system under each MTTF level
    at the tight SLO (1.5 — where the dominance ordering is
    reproducible).  Feeds graceful-degradation: per-system finish rate
    must fall monotonically (within slack) with no cliff between
    adjacent levels, and ORLOJ must stay on top at every level."""
    return [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=1.5,
            utilization=0.85 * 2,
            n_requests=300,
            seed=seed,
            system=system,
            n_workers=2,
            policy="least_loaded",
            faults=_chaos_plan(level_x, seed),
            tag=f"chaos/degrade-{level}/{system}/s{seed}",
        )
        for level, level_x in _CHAOS_LEVELS
        for system in systems
        for seed in seeds
    ]


def chaos() -> list[ExperimentSpec]:
    """The chaos grid: noop twins + scalar/array equivalence under
    active plans (flat and fleet) + the graceful-degradation severity
    ladder.  Gated on ``fault-free-noop``, ``graceful-degradation`` and
    ``array-scalar-equivalence`` (claims layer)."""
    return (
        _chaos_noop_twins(seeds=(7, 11))
        + _chaos_equiv_cells(fleet=True)
        + _chaos_degradation(seeds=(7, 11, 23))
    )


def chaos_smoke() -> list[ExperimentSpec]:
    """Trimmed CI tier of :func:`chaos`: one noop-twin set, the flat
    equivalence pair, and a single-seed severity ladder over
    {orloj, nexus, clockwork} (~30 s serial)."""
    return (
        _chaos_noop_twins(seeds=(7,))
        + _chaos_equiv_cells(fleet=False)
        + _chaos_degradation(seeds=(7,), systems=("orloj", "nexus", "clockwork"))
    )


# --------------------------------------------------------------------------
# Token-mode grids (DESIGN.md §12): continuous-batching decode cells.
# ``slo_scale`` is the TPOT tightness axis (tpot = scale × one
# reference-batch step time); systems are the token schedulers
# (length-aware ``token_orloj`` vs length-blind ``token_fcfs``), feeding
# the ``token-length-awareness`` claim, with scalar/array paired cells
# extending ``array-scalar-equivalence`` to resumable decode runs.

_TOKEN_SYSTEMS = ("token_orloj", "token_fcfs")


def _token_cells(
    slos: Sequence[float],
    seeds: Sequence[int],
    n_requests: int,
    engines: Sequence[str] = ("scalar",),
    utilization: float = 0.85,
) -> list[ExperimentSpec]:
    return [
        ExperimentSpec(
            workload="tokens",
            workload_params={"short_mean": 8.0, "long_mean": 64.0},
            slo_scale=slo,
            utilization=utilization,
            n_requests=n_requests,
            seed=seed,
            system=system,
            engine=engine,
            lm_c0=2.0,  # decode-step cost model: 2 + 0.25·k ms per step
            lm_c1=0.25,
            tag=f"tokens/slo{slo:g}/{system}/s{seed}/{engine}",
        )
        for slo in slos
        for seed in seeds
        for system in _TOKEN_SYSTEMS
        for engine in engines
    ]


def tokens() -> list[ExperimentSpec]:
    """The token-mode conformance grid: tight TPOT scales (1.25, 1.5) for
    the length-awareness ordering plus a loose anchor (3.0) for
    monotonicity, 5 seeds, both token systems; plus scalar/array paired
    cells extending the equivalence claim to decode.  The equivalence
    pairs run at a distinct utilization so their case label never
    seed-averages into the ordering sweep's cells."""
    return _token_cells(
        slos=(1.25, 1.5, 3.0), seeds=_SMALL_SEEDS, n_requests=300
    ) + _token_cells(
        slos=(1.25,),
        seeds=(13,),
        n_requests=300,
        engines=("scalar", "array"),
        utilization=0.9,
    )


def tokens_smoke() -> list[ExperimentSpec]:
    """Trimmed CI tier of :func:`tokens`: two seeds at a tight and a loose
    TPOT scale plus one scalar/array equivalence pair (~seconds)."""
    return _token_cells(
        slos=(1.25, 3.0), seeds=(7, 11), n_requests=200
    ) + _token_cells(
        slos=(1.25,),
        seeds=(13,),
        n_requests=200,
        engines=("scalar", "array"),
        utilization=0.9,
    )


# --------------------------------------------------------------------------
# Multi-model grids (DESIGN.md §13): Zipf-skewed traffic over a zoo
# roster with a weights-residency cache per worker.  Feeds two gated
# claims: ``single-model-noop`` (the tier is bitwise inert at
# n_models=1, scalar AND array) and ``cold-start-dominance``
# (residency-aware dispatch beats residency-blind round_robin under
# memory pressure), plus scalar/array equivalence pairs under an active
# residency plan on both eviction policies.

# 3 GiB holds roughly one resident zoo model (olmo_1b 2.19 GiB +
# internvl2_1b 1.17 GiB > 3 GiB) — the memory-pressure point where
# residency-blind dispatch reloads weights on nearly every batch.
_MM_MEM = float(3 * 2**30)


def _mm_noop_twins(seeds: Sequence[int]) -> list[ExperimentSpec]:
    """Paired cells per (engine, seed): identical specs except one leaves
    every multi-model knob at its default and the other sets skew, memory
    and eviction policy while keeping ``n_models=1``.  The
    single-model-noop claim asserts each pair is bitwise identical — the
    residency tier costs nothing until a second model exists."""
    base = dict(
        workload="bimodal",
        workload_params={"std": 1.0},
        slo_scale=1.5,
        utilization=0.85 * 2,
        n_requests=300,
        # 2-worker pool, like the chaos noop twins: keeps the twins out
        # of the single-worker paper-claim domains (which would state
        # tight-slo-dominance on a grid carrying no baselines).
        n_workers=2,
        policy="round_robin",
    )
    return [
        ExperimentSpec(
            **base,
            **knobs,
            seed=seed,
            engine=engine,
            tag=f"mm/noop-{variant}/{engine}/s{seed}",
        )
        for seed in seeds
        for engine in ("scalar", "array")
        for variant, knobs in (
            ("bare", {}),
            (
                "inert",
                dict(
                    n_models=1,
                    model_skew=1.7,
                    worker_mem=_MM_MEM,
                    residency_policy="cost_aware",
                ),
            ),
        )
    ]


def _mm_coldstart_cells(
    seeds: Sequence[int], n_requests: int = 400
) -> list[ExperimentSpec]:
    """The memory-pressure sweep: 4 zoo models over a 4-worker pool whose
    cache holds ~1 model, residency-aware vs residency-blind dispatch on
    the same traces.  Offered load 0.4 x 4 capacities — low enough that
    the Zipf head fits on one worker, so the comparison isolates
    cold-start churn rather than load imbalance."""
    return [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=1.5,
            utilization=0.4 * 4,
            n_requests=n_requests,
            seed=seed,
            system="orloj",
            n_workers=4,
            policy=policy,
            n_models=4,
            worker_mem=_MM_MEM,
            tag=f"mm/coldstart/{policy}/s{seed}",
        )
        for policy in ("residency", "round_robin")
        for seed in seeds
    ]


def _mm_equiv_cells() -> list[ExperimentSpec]:
    """Scalar/array twins under an *active* residency plan, one pair per
    eviction policy, extending array-scalar-equivalence to weight-load
    stalls (the residency counters are equivalence fields too).  Distinct
    utilization so their case label never seed-averages into the
    cold-start sweep's cells."""
    return [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=1.5,
            utilization=0.5 * 4,
            n_requests=400,
            seed=13,
            system="orloj",
            n_workers=4,
            policy="residency",
            n_models=4,
            worker_mem=_MM_MEM,
            residency_policy=respolicy,
            engine=engine,
            tag=f"mm/equiv-{respolicy}/{engine}",
        )
        for respolicy in ("lru", "cost_aware")
        for engine in ("scalar", "array")
    ]


def multi_model() -> list[ExperimentSpec]:
    """The multi-model grid: noop twins (both engines), the cold-start
    dominance sweep at 5 seeds, and scalar/array equivalence pairs under
    both eviction policies.  Gated on ``single-model-noop``,
    ``cold-start-dominance`` and ``array-scalar-equivalence``."""
    return (
        _mm_noop_twins(seeds=(7, 11))
        + _mm_coldstart_cells(seeds=_SMALL_SEEDS)
        + _mm_equiv_cells()
    )


def multi_model_smoke() -> list[ExperimentSpec]:
    """Trimmed CI tier of :func:`multi_model`: one noop-twin set, a
    3-seed cold-start sweep, and the equivalence pairs (~30 s serial)."""
    return (
        _mm_noop_twins(seeds=(7,))
        + _mm_coldstart_cells(seeds=(7, 11, 23))
        + _mm_equiv_cells()
    )


def slo2_bimodal() -> list[ExperimentSpec]:
    """Diagnostic grid for the intermediate-SLO regime (DESIGN.md §7):
    bimodal at SLO scales around 2 x P99, ORLOJ vs Nexus, 5 seeds.
    Feeds the *bounding* claim ``nexus-slo2-gap`` — the regime where
    Nexus's fixed-batch plan is genuinely competitive in this repro is
    documented and bounded, not asserted away."""
    return [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=slo,
            n_requests=300,
            seed=seed,
            system=system,
            tag=f"slo2/bimodal/slo{slo:g}/{system}/s{seed}",
        )
        for slo in (1.75, 2.0, 2.25)
        for system in ("orloj", "nexus")
        for seed in _SMALL_SEEDS
    ]


GRIDS = {
    "tiny": tiny,
    "small": small,
    "full": full,
    "engine-smoke": engine_smoke,
    "cluster": cluster_fleet,
    "cluster-smoke": cluster_smoke,
    "chaos": chaos,
    "chaos-smoke": chaos_smoke,
    "slo2-bimodal": slo2_bimodal,
    "tokens": tokens,
    "tokens-smoke": tokens_smoke,
    "multi-model": multi_model,
    "multi-model-smoke": multi_model_smoke,
}


# --------------------------------------------------------------------------
# Legacy benchmark sweeps (benchmarks/*.py), one constructor per table/fig.
# ``tag`` is the full legacy CSV row name wherever it is spec-derivable.

_SLOS_FULL = (1.5, 2.0, 3.0, 4.0, 5.0)
_SLOS_FAST = (1.5, 3.0, 5.0)


def _table_specs(
    table: str,
    cases: list[tuple[str, str, dict]],
    slos: Sequence[float],
    *,
    utilization: float = 0.85,
    n_requests: int = 1200,
    seed: int = 7,
) -> list[ExperimentSpec]:
    return [
        ExperimentSpec(
            workload=family,
            workload_params=dict(params),
            slo_scale=slo,
            utilization=utilization,
            n_requests=n_requests,
            seed=seed,
            system=system,
            tag=f"{table}/{case}/slo{slo:g}/{system}",
        )
        for case, family, params in cases
        for slo in slos
        for system in SYSTEMS
    ]


def table2(full: bool = False) -> list[ExperimentSpec]:
    """Table 2: bimodal request distributions with varying per-peak std."""
    cases = [
        ("std-0.5", "bimodal", {"std": 0.5}),
        ("std-1", "bimodal", {"std": 1.0}),
        ("std-2", "bimodal", {"std": 2.0}),
        ("std-2/0.5", "bimodal", {"std": [2.0, 0.5]}),
        ("std-0.5/2", "bimodal", {"std": [0.5, 2.0]}),
    ]
    return _table_specs("table2", cases, _SLOS_FULL if full else _SLOS_FAST)


def table3(full: bool = False) -> list[ExperimentSpec]:
    """Table 3 / Fig. 8: one- to eight-modal distributions."""
    ks = range(1, 9) if full else (1, 2, 3, 5, 8)
    cases = [(f"{k}-modal", "k_modal", {"k": k}) for k in ks]
    return _table_specs("table3", cases, _SLOS_FULL if full else _SLOS_FAST)


def fig9(full: bool = False) -> list[ExperimentSpec]:
    cases = [
        (f"more-{m}", "unequal_bimodal", {"more": m}) for m in ("short", "long")
    ]
    return _table_specs("fig9", cases, _SLOS_FULL if full else _SLOS_FAST)


def table4(full: bool = False) -> list[ExperimentSpec]:
    """Table 4 / Fig. 11: static models (no execution-time variance)."""
    cases = [
        ("inception", "static", {"mean": 12.0}),
        ("resnet", "static", {"mean": 7.0}),
    ]
    return _table_specs(
        "table4", cases, _SLOS_FULL if full else _SLOS_FAST, utilization=0.7
    )


def table5(full: bool = False) -> list[ExperimentSpec]:
    """Table 5: real model/dataset pairs fitted from published mean/P99."""
    from ..serving.workload import REAL_TASKS

    names = (
        list(REAL_TASKS)
        if full
        else ["gpt-cornell", "bart-cnn", "skipnet-imagenet", "rdinet-cifar"]
    )
    cases = [(name, "real", {"name": name}) for name in names]
    return _table_specs("table5", cases, _SLOS_FULL if full else _SLOS_FAST)


def ablation(full: bool = False) -> list[ExperimentSpec]:
    variants = {
        "base": {},
        "paper-desc-order": {"bs_order": "paper_desc"},
        "no-refine": {"refine_feasibility": False},
        "bins-4": {"n_bins": 4},
        "bins-32": {"n_bins": 32},
    }
    return [
        ExperimentSpec(
            workload="k_modal",
            workload_params={"k": 3},
            slo_scale=slo,
            utilization=0.8,  # the legacy sweeps used TraceConfig's default
            n_requests=1200,
            seed=11,
            system="orloj",
            sched_cfg=dict(cfg),
            tag=f"ablation/{name}/slo{slo:g}",
        )
        for name, cfg in variants.items()
        for slo in (1.5, 3.0, 5.0)
    ]


def fig13(full: bool = False) -> list[ExperimentSpec]:
    """Sensitivity to the anticipated-delay parameter b (3-modal)."""
    bs = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
    slos = (1.5, 2.0, 3.0, 4.0, 5.0) if full else (2.0, 3.0, 5.0)
    return [
        ExperimentSpec(
            workload="k_modal",
            workload_params={"k": 3},
            slo_scale=slo,
            utilization=0.8,  # the legacy sweeps used TraceConfig's default
            n_requests=1000,
            seed=3,
            system="orloj",
            sched_cfg={"b": b},
            tag=f"fig13/slo{slo:g}/b{b:g}",
        )
        for slo in slos
        for b in bs
    ]


def fig14(full: bool = False) -> list[ExperimentSpec]:
    """Shrink the execution-time scale until scheduling overhead bites.
    ``tag`` is completed by the formatter (needs the measured P99)."""
    scales = (
        (1.0, 0.5, 0.25, 0.1, 0.075, 0.05, 0.025)
        if full
        else (1.0, 0.5, 0.25, 0.1, 0.05)
    )
    return [
        ExperimentSpec(
            workload="k_modal",
            workload_params={"k": 3},
            slo_scale=slo,
            utilization=0.8,  # the legacy sweeps used TraceConfig's default
            n_requests=800,
            seed=4,
            system="orloj",
            lm_c0=25.0 * scale,
            time_scale=scale,
            charge_overhead=True,
            tag=f"fig14/scale{scale:g}/slo{slo:g}",
        )
        for scale in scales
        for slo in (1.5, 3.0, 5.0)
    ]


def cluster(full: bool = False) -> list[ExperimentSpec]:
    """Scale-out: finish rate vs replica count and dispatch policy."""
    from ..core.eventloop import DISPATCH_POLICIES

    replicas = (1, 2, 4, 8) if full else (1, 2, 4)
    n = 1500 if full else 800
    return [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=3.0,
            utilization=0.8 * k,  # offered load ~ 0.8 x k worker capacities
            n_requests=n,
            seed=13,
            system="orloj",
            n_workers=k,
            policy=policy,
            loop_seed=0,  # the pre-refactor simulate_cluster default
            tag=f"cluster/{policy}/r{k}",
        )
        for k in replicas
        for policy in DISPATCH_POLICIES
    ]


def cluster_hetero(full: bool = False) -> list[ExperimentSpec]:
    """Mixed pool: half fast, half 2x-slow replicas (a slow replica is
    worth half a fast one, hence the 0.8 x 3 offered load at k=4)."""
    from ..core.eventloop import DISPATCH_POLICIES

    k = 4
    n = 1500 if full else 800
    return [
        ExperimentSpec(
            workload="bimodal",
            workload_params={"std": 1.0},
            slo_scale=3.0,
            utilization=0.8 * (k / 2 + k / 4),
            n_requests=n,
            seed=13,
            system="orloj",
            n_workers=k,
            policy=policy,
            hetero=True,
            loop_seed=1,  # the pre-refactor cluster_hetero loop seed
            tag=f"cluster_hetero/{policy}/r{k}",
        )
        for policy in DISPATCH_POLICIES
    ]
