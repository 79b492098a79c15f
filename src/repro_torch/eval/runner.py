"""Run experiment specs: one seeded replay per cell, processes fanned out.

This is stage 2 of the grid-cell lifecycle (spec → seeded RequestSet →
result → claim, see :mod:`repro.eval.spec`).  Every cell is
self-contained — ``run_spec`` regenerates the request set from the spec's
seed (bit-for-bit, see the replay-fairness test) and replays it through
the unified event loop — so the grid parallelizes with no shared state:
serial and parallel execution produce identical outcome fields.

Substrates: ``substrate="sim"`` cells replay against the Eq.-3
:class:`~repro.core.eventloop.ModelExecutor` and fan out over a process
pool.  ``substrate="engine"`` cells (:mod:`repro.eval.substrate`) run the
real JAX engine and always execute serially in the host process — the
engine's model parameters, compiled programs and profiled latency curve
are cached per process, and re-paying model init + XLA compilation in
every pool worker would dwarf the cells themselves.

``write_artifact`` persists a result set as ``BENCH_eval.json`` next to
``BENCH_sched.json``.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterable, Sequence

import numpy as np

from ..core import (
    BASELINES,
    BatchLatencyModel,
    ModelExecutor,
    MultiModelOrlojScheduler,
    OrlojScheduler,
    SchedulerConfig,
    Worker,
    run_event_loop,
)
from ..core.eventloop import DecodeModelExecutor, Executor, SimResult
from ..core.tokensched import (
    FcfsTokenScheduler,
    LengthAwareTokenScheduler,
    TokenSchedConfig,
)
from ..serving.faults import FaultPlan
from ..serving.residency import ResidencyPlan, latency_scales, model_roster
from ..serving.trace import (
    RequestSet,
    TraceConfig,
    generate_requests,
    generate_token_requests,
)
from .spec import ExperimentResult, ExperimentSpec
from .workloads import build_workload

__all__ = [
    "run_spec",
    "run_specs",
    "write_artifact",
    "read_artifact",
    "token_sched_config",
    "generate_token_set",
    "DEFAULT_ARTIFACT",
]

DEFAULT_ARTIFACT = "BENCH_eval.json"


def _make_scheduler(
    spec: ExperimentSpec,
    lm: BatchLatencyModel,
    rs: RequestSet,
    batch_sizes: tuple[int, ...] | None = None,
):
    """Instantiate the spec's scheduler.  ``batch_sizes`` pins the
    supported batch grid (the engine substrate passes its executor's
    supported sizes so the scheduler never plans an unservable batch);
    an explicit ``sched_cfg`` entry still wins."""
    if spec.system == "orloj":
        cfg_kw = dict(spec.sched_cfg)
        if batch_sizes is not None:
            cfg_kw.setdefault("batch_sizes", tuple(batch_sizes))
        cfg = SchedulerConfig(**cfg_kw)
        if spec.n_models > 1:
            # One BinScoreModel per zoo model: each model's alone-time
            # distributions are the base trace dists scaled by its
            # latency ladder (the same scaling _assign_models applied to
            # true_time), so the priors match the replayed traffic.
            base = rs.initial_dists()
            dists = {
                m: {a: d.affine(s, 0.0) for a, d in base.items()}
                for m, s in zip(
                    model_roster(spec.n_models), latency_scales(spec.n_models)
                )
            }
            return MultiModelOrlojScheduler(lm, dists, cfg=cfg)
        return OrlojScheduler(lm, cfg=cfg, initial_dists=rs.initial_dists())
    if spec.n_models > 1:
        raise ValueError(
            "multi-model cells support system='orloj' only: baselines "
            "have no per-model distribution state to key batches by "
            "(DESIGN.md §13)"
        )
    try:
        cls = BASELINES[spec.system]
    except KeyError:
        raise ValueError(
            f"unknown system {spec.system!r}; known: "
            f"{['orloj', *sorted(BASELINES)]}"
        ) from None
    kw = {} if batch_sizes is None else {"batch_sizes": tuple(batch_sizes)}
    # Baselines are warm-started from the same historical samples ORLOJ's
    # initial distributions are built from (§5.2 fairness).
    return cls(lm, init_samples=rs.warm_samples(), **kw)


def _slow_lm(lm: BatchLatencyModel) -> BatchLatencyModel:
    """The heterogeneous-pool convention, shared by both substrates: the
    back half of the pool runs a 2x-slower latency curve (and, on the
    engine substrate, a 2x-scaled executor)."""
    return BatchLatencyModel(c0=2.0 * lm.c0, c1=2.0 * lm.c1)


def _build_pool(
    spec: ExperimentSpec,
    lm: BatchLatencyModel,
    rs: RequestSet,
    executor_for: Callable[[int, BatchLatencyModel, bool], Executor],
    batch_sizes: tuple[int, ...] | None = None,
) -> list[Worker]:
    """Assemble the spec's worker pool — the one place the heterogeneous
    convention (back half of the pool 2x slower) lives, shared by the sim
    substrate, the engine substrate and its sim twin.  ``executor_for(i,
    wlm, slow)`` supplies each replica's executor."""
    slow = _slow_lm(lm)
    workers = []
    for i in range(spec.n_workers):
        is_slow = spec.hetero and i >= spec.n_workers // 2
        wlm = slow if is_slow else lm
        workers.append(
            Worker(
                _make_scheduler(spec, wlm, rs, batch_sizes=batch_sizes),
                executor_for(i, wlm, is_slow),
            )
        )
    return workers


def _token_metrics(reqs: Sequence) -> dict:
    """TTFT/TPOT quantiles + token throughput from a replayed token-mode
    request list (``first_token``/``tokens_done`` are object state written
    identically by both engines, so these fold bit-identically)."""
    ttfts: list[float] = []
    tpots: list[float] = []
    n_tok = 0
    for r in reqs:
        n_tok += r.tokens_done
        if r.first_token is not None:
            ttfts.append(r.first_token - r.release)
        if r.finished is not None and r.tokens_done > 1:
            tpots.append((r.finished - r.first_token) / (r.tokens_done - 1))

    def q(xs: list[float], p: float) -> float:
        return float(np.quantile(np.asarray(xs), p)) if xs else 0.0

    return dict(
        ttft_p50_ms=q(ttfts, 0.5),
        ttft_p99_ms=q(ttfts, 0.99),
        tpot_p50_ms=q(tpots, 0.5),
        tpot_p99_ms=q(tpots, 0.99),
        n_tokens_out=n_tok,
    )


def _fold_result(
    spec: ExperimentSpec,
    rs: RequestSet,
    res: SimResult,
    wall_s: float,
    substrate_meta: dict | None = None,
    token_metrics: dict | None = None,
) -> ExperimentResult:
    """Fold one replay's :class:`~repro.core.eventloop.SimResult` into the
    :class:`ExperimentResult` schema — the single mapping both substrates
    go through, so engine and sim results can never diverge field-wise."""
    lat = res.latencies
    return ExperimentResult(
        spec=spec,
        finish_rate=res.finish_rate,
        n_total=res.n_total,
        n_finished_ok=res.n_finished_ok,
        n_finished_late=res.n_finished_late,
        n_dropped=res.n_dropped,
        n_unserved=res.n_unserved,
        n_rejected=res.n_rejected,
        n_failed=res.n_failed,
        n_retried=res.n_retried,
        n_model_loads=res.n_model_loads,
        n_model_evicts=res.n_model_evicts,
        model_load_ms=res.model_load_ms,
        truncated=res.truncated,
        utilization=res.utilization,
        makespan_ms=res.makespan_ms,
        p99_alone_ms=rs.p99_alone,
        latency_p50_ms=float(np.quantile(lat, 0.5)) if len(lat) else 0.0,
        latency_p99_ms=float(np.quantile(lat, 0.99)) if len(lat) else 0.0,
        n_decisions=res.n_decisions,
        sched_time_ms=res.sched_time_ms,
        sched_us_per_request=res.sched_us_per_request,
        wall_s=wall_s,
        substrate_meta=substrate_meta or {},
        **(token_metrics or {}),
    )


def token_sched_config(spec: ExperimentSpec) -> TokenSchedConfig:
    """The spec's token-mode scheduler config (DESIGN.md §12).  The
    spec's Eq.-3 constants double as the decode-step cost model
    (``d0 + d1·k`` per step) and ``slo_scale`` is the TPOT tightness
    axis: ``tpot = slo_scale × (d0 + d1·reference_batch)`` — scale 1
    means "exactly one reference-batch step per token", so scales just
    above 1 bind hard and large scales are loose.  TTFT rides along at
    ``ttft_mult`` TPOTs."""
    p = spec.workload_params
    d0, d1 = spec.lm_c0, spec.lm_c1
    k_ref = int(p.get("reference_batch", 8))
    tpot = spec.slo_scale * (d0 + d1 * k_ref)
    return TokenSchedConfig(
        max_batch=int(p.get("max_batch", 16)),
        ttft_slo_ms=float(p.get("ttft_mult", 8.0)) * tpot,
        tpot_slo_ms=tpot,
        d0=d0,
        d1=d1,
        prefill_per_token=float(p.get("prefill_per_token", 0.02)),
    )


def generate_token_set(spec: ExperimentSpec) -> RequestSet:
    """Regenerate a ``tokens`` spec's seeded request set (bit-for-bit,
    same replay-fairness contract as :func:`generate_requests`)."""
    cfg = token_sched_config(spec)
    apps = build_workload(spec.workload, spec.workload_params, spec.time_scale)
    return generate_token_requests(
        apps,
        d0=cfg.d0,
        d1=cfg.d1,
        prefill_per_token=cfg.prefill_per_token,
        ttft_slo_ms=cfg.ttft_slo_ms,
        tpot_slo_ms=cfg.tpot_slo_ms,
        cfg=TraceConfig(
            n_requests=spec.n_requests,
            utilization=spec.utilization,
            reference_batch=int(spec.workload_params.get("reference_batch", 8)),
            seed=spec.seed,
            tick_ms=spec.tick_ms,
        ),
    )


def _run_token_spec(spec: ExperimentSpec) -> ExperimentResult:
    """Replay one ``tokens`` cell: a token scheduler driving resumable
    decode batches through the event loop (DESIGN.md §12).  Token cells
    are sim-substrate, single-worker, fault-free by construction — the
    real-engine decode path is exercised by ``ServingEngine.serve_tokens``
    under the slow test tier, not by grid cells."""
    if spec.substrate != "sim":
        raise ValueError(
            "tokens cells run on the sim substrate only; the real decode "
            "path is ServingEngine.serve_tokens (slow test tier)"
        )
    if spec.n_workers != 1 or spec.n_pools != 1:
        raise ValueError(
            "tokens cells are single-worker: one continuous batch per "
            "replica is the unit the token schedulers reason about"
        )
    if spec.faults:
        raise ValueError("decode (token-level) cells do not support fault plans")
    if spec.n_models > 1:
        raise ValueError(
            "decode (token-level) cells do not support multi-model "
            "serving (DESIGN.md §13)"
        )
    if spec.sched_cfg:
        raise ValueError(
            "tokens cells configure schedulers via workload_params "
            "(max_batch, ttft_mult, ...), not sched_cfg"
        )
    t_wall = time.perf_counter()  # simlint: ignore[R1] -- wall_time_s metadata column; the replay itself is virtual-time
    cfg = token_sched_config(spec)
    rs = generate_token_set(spec)
    if spec.system == "token_orloj":
        sched = LengthAwareTokenScheduler(
            cfg, initial_len_dists=rs.initial_dists(n_bins=cfg.n_bins)
        )
    elif spec.system == "token_fcfs":
        sched = FcfsTokenScheduler(cfg)
    else:
        raise ValueError(
            f"unknown token system {spec.system!r}; "
            f"known: ['token_fcfs', 'token_orloj']"
        )
    reqs = rs.fresh()
    res = run_event_loop(
        reqs,
        [Worker(sched, DecodeModelExecutor(cfg.d0, cfg.d1, cfg.prefill_per_token))],
        charge_scheduler_overhead=spec.charge_overhead,
        seed=spec.seed if spec.loop_seed is None else spec.loop_seed,
        engine=spec.engine,
        wall_budget_s=spec.wall_budget_s,
    )
    return _fold_result(
        spec, rs, res,
        time.perf_counter() - t_wall,  # simlint: ignore[R1] -- wall_s metadata column; the replay itself is virtual-time
        token_metrics=_token_metrics(reqs),
    )


def run_spec(spec: ExperimentSpec) -> ExperimentResult:
    """Regenerate the spec's seeded request set and replay it once (on the
    spec's substrate)."""
    if spec.workload == "tokens":
        return _run_token_spec(spec)
    if spec.n_models > 1 and spec.substrate != "sim":
        raise ValueError(
            "multi-model cells run on the sim substrate only: the engine "
            "substrate serves one compiled model per process (DESIGN.md §13)"
        )
    if spec.substrate != "sim":
        # Deferred import: the engine substrate pulls in the JAX model
        # stack only when an engine cell actually runs, so sim-only
        # environments (the bare-env CI job) never touch it.
        from .substrate import run_engine_spec

        return run_engine_spec(spec)
    t_wall = time.perf_counter()  # simlint: ignore[R1] -- wall_time_s metadata column; the replay itself is virtual-time
    lm = BatchLatencyModel(c0=spec.lm_c0, c1=spec.lm_c1)
    apps = build_workload(spec.workload, spec.workload_params, spec.time_scale)
    rs = generate_requests(
        apps,
        lm,
        slo_scale=spec.slo_scale,
        cfg=TraceConfig(
            n_requests=spec.n_requests,
            utilization=spec.utilization,
            seed=spec.seed,
            tick_ms=spec.tick_ms,
            n_models=spec.n_models,
            model_skew=spec.model_skew,
        ),
    )
    residency = None
    if spec.n_models > 1:
        if spec.worker_mem <= 0:
            raise ValueError(
                "multi-model cells must set worker_mem (cache capacity "
                "in bytes; DESIGN.md §13)"
            )
        residency = ResidencyPlan.from_zoo(
            model_roster(spec.n_models),
            worker_mem=spec.worker_mem,
            policy=spec.residency_policy,
        )
    policy: str | Callable = spec.policy
    if spec.n_pools > 1:
        # Fleet mode: the spec's policy routes BETWEEN pools, intra_policy
        # places within the winning pool (serving.cluster).
        from ..serving.cluster import hierarchical_policy

        policy = hierarchical_policy(
            spec.n_workers,
            spec.n_pools,
            inter=spec.policy,
            intra=spec.intra_policy,
            seed=spec.seed if spec.loop_seed is None else spec.loop_seed,
        )
    # Fault plan: spec.faults is a plain dict (artifact-serializable);
    # an *empty* dict means no plan at all, while a populated-but-disabled
    # dict still threads a FaultPlan through the engine hooks — that
    # distinction is what makes the fault-free-noop claim non-vacuous.
    faults = FaultPlan.from_dict(spec.faults) if spec.faults else None
    res = run_event_loop(
        rs.fresh(),
        _build_pool(spec, lm, rs, lambda i, wlm, slow: ModelExecutor(wlm, seed=i)),
        policy=policy,
        charge_scheduler_overhead=spec.charge_overhead,
        seed=spec.seed if spec.loop_seed is None else spec.loop_seed,
        engine=spec.engine,
        faults=faults,
        residency=residency,
        wall_budget_s=spec.wall_budget_s,
    )
    # simlint: ignore[R1] -- wall_time_s metadata column; the replay itself is virtual-time
    return _fold_result(spec, rs, res, time.perf_counter() - t_wall)


def run_specs(
    specs: Sequence[ExperimentSpec], jobs: int = 1
) -> list[ExperimentResult]:
    """Run a grid; results come back in spec order.

    ``jobs > 1`` fans cells out over a process pool (each cell regenerates
    its own request set, so there is nothing to share); ``jobs <= 0`` means
    one process per CPU.
    """
    specs = list(specs)
    if jobs <= 0:
        jobs = os.cpu_count() or 1
    # Engine cells always run serially in the host process: the engine's
    # compiled programs and profiled latency curve are cached per process,
    # and every pool worker would re-pay model init + XLA compilation.
    sim_idx = [i for i, s in enumerate(specs) if s.substrate == "sim"]
    if jobs == 1 or len(sim_idx) <= 1:
        return [run_spec(s) for s in specs]
    results: list[ExperimentResult | None] = [None] * len(specs)
    chunk = max(1, len(sim_idx) // (4 * jobs))
    # Spawn, not fork: the host process may have JAX's threads running
    # (e.g. under pytest after real-engine tests), and forking a
    # multithreaded process can deadlock.  Workers only import numpy-level
    # code, so the spawn import cost is small and paid once per worker.
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
        sim_results = pool.map(
            run_spec, [specs[i] for i in sim_idx], chunksize=chunk
        )
        # Engine cells run in the host while the pool churns through the
        # sim cells: mixed grids cost max(sim, engine) wall, not the sum.
        for i, s in enumerate(specs):
            if s.substrate != "sim":
                results[i] = run_spec(s)
        for i, r in zip(sim_idx, sim_results):
            results[i] = r
    return results  # type: ignore[return-value]


def write_artifact(
    path: str,
    results: Iterable[ExperimentResult],
    grid: str = "",
    claims: Sequence | None = None,
    extra: dict | None = None,
) -> dict:
    """Write the trajectory artifact (atomically) and return the document.

    ``extra`` merges additional top-level sections into the document (e.g.
    the ``engine_drift`` report of an engine-substrate grid)."""
    results = list(results)
    doc: dict = {
        "schema": 1,
        "grid": grid,
        "n_results": len(results),
        "results": [r.to_dict() for r in results],
    }
    if claims is not None:
        doc["claims"] = [c.to_dict() for c in claims]
        doc["passed"] = all(c.passed for c in claims)
    if extra:
        reserved = {"schema", "grid", "n_results", "results", "claims", "passed"}
        clash = reserved & extra.keys()
        if clash:
            raise ValueError(
                f"extra sections would overwrite reserved artifact keys: "
                f"{sorted(clash)}"
            )
        doc.update(extra)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return doc


def read_artifact(path: str) -> tuple[dict, list[ExperimentResult]]:
    with open(path) as f:
        doc = json.load(f)
    return doc, [ExperimentResult.from_dict(d) for d in doc["results"]]
