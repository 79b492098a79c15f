"""Typed experiment grid cells: :class:`ExperimentSpec` in,
:class:`ExperimentResult` out.

A spec is the complete, JSON-serializable recipe for one run:
workload family + params, SLO scale, offered utilization, trace seed,
compared system, pool shape, execution substrate, and the knobs the
sensitivity/ablation studies sweep.  Everything a worker process needs to
regenerate the seeded request set and replay it — no shared state, so a
grid of specs fans out across processes trivially.

**Grid-cell lifecycle** (the contract every module in ``repro.eval``
implements one stage of):

1. a grid constructor (:mod:`repro.eval.grid`) builds a list of specs;
2. the runner (:mod:`repro.eval.runner`) regenerates each spec's *seeded*
   :class:`~repro.serving.trace.RequestSet` — bit-for-bit reproducible
   from ``(workload, workload_params, slo_scale, utilization, n_requests,
   seed)`` — and replays it through the unified event loop on the spec's
   ``substrate``;
3. the replay folds into an :class:`ExperimentResult` (same schema for
   both substrates);
4. the claims layer (:mod:`repro.eval.claims`) aggregates results into
   paper-claim verdicts, and ``repro.eval.run`` persists everything as
   ``BENCH_eval.json``.

``substrate`` selects the execution layer under the replay: ``"sim"``
(default) uses the Eq.-3 :class:`~repro.core.eventloop.ModelExecutor`;
``"engine"`` (optionally ``"engine:<model>"``, see
:mod:`repro.eval.substrate`) drives the real JAX
:class:`~repro.serving.engine.ServingEngine` with measured batch times.

Results split into *outcome* fields (deterministic given the spec on the
``sim`` substrate — finish counts, utilization, latency quantiles) and
*timing* fields (measured wall-clock — scheduler decision time, run wall
time).  Determinism comparisons go through
:meth:`ExperimentResult.stable_dict`, which drops the timing fields.  On
the ``engine`` substrate the outcome fields are real measurements and
therefore machine-dependent; engine provenance (profiled constants,
predicted-vs-measured drift, the finish set) travels in
``substrate_meta``, which is likewise excluded from stable comparisons.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

__all__ = ["ExperimentSpec", "ExperimentResult", "TIMING_FIELDS"]


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One grid cell.  ``workload_params`` / ``sched_cfg`` are plain JSON
    objects (lists instead of tuples) so a spec round-trips losslessly."""

    workload: str  # family key in repro.eval.workloads.FAMILIES
    slo_scale: float
    workload_params: dict = dataclasses.field(default_factory=dict)
    utilization: float = 0.85
    n_requests: int = 300
    seed: int = 0
    system: str = "orloj"  # "orloj" or a repro.core.baselines.BASELINES key
    # Execution layer: "sim" replays against the Eq.-3 ModelExecutor;
    # "engine" (or "engine:<registry model>") drives the real JAX
    # ServingEngine with measured batch times (repro.eval.substrate).
    substrate: str = "sim"
    n_workers: int = 1
    policy: str = "round_robin"  # front-end dispatch for n_workers > 1
    hetero: bool = False  # half the pool runs a 2x-slower latency model
    # Event-loop implementation (repro.core.eventloop.ENGINES): "scalar"
    # is the oracle heapq loop, "array" the RequestStore/EventWheel engine
    # (bit-identical observable behaviour, built for 10^5+ requests).
    engine: str = "scalar"
    # Fleet mode: n_pools > 1 partitions the pool into contiguous pools
    # and dispatches hierarchically — ``policy`` becomes the inter-pool
    # (front-end) policy, ``intra_policy`` places within the winning pool
    # (serving.cluster.hierarchical_policy).
    n_pools: int = 1
    intra_policy: str = "round_robin"
    # Arrival quantization tick (TraceConfig.tick_ms); 0 = raw timestamps.
    tick_ms: float = 0.0
    # Wall-clock budget (s) for this cell; 0 = unbudgeted.  Budgeted cells
    # feed the cluster-wall-budget claim: the replay (wall_s) must finish
    # inside the budget, which is what gates the fleet-scale grids.  An
    # overrun is graceful: the event loop cuts the replay off and the
    # result comes back ``truncated`` with partial stats (everything
    # unresolved counted unserved) instead of hanging the grid.
    wall_budget_s: float = 0.0
    # Fault plan for this cell as a plain JSON object (the kwargs of
    # :class:`repro.serving.faults.FaultPlan`).  Empty dict = no plan at
    # all; a populated dict with every knob off is a *disabled* plan that
    # still threads through the engine hooks (the fault-free-noop claim's
    # domain).  DESIGN.md §11.
    faults: dict = dataclasses.field(default_factory=dict)
    # Multi-model serving (DESIGN.md §13): n_models > 1 assigns each
    # request a zoo model (Zipf-skewed by model_skew) and threads a
    # weights-residency cache of ``worker_mem`` bytes through the event
    # loop — cold batches stall for the PCIe load before executing.
    # Defaults keep the tier fully inert: n_models=1 cells are bitwise
    # identical to pre-multi-model cells (the single-model-noop claim).
    n_models: int = 1
    model_skew: float = 1.1
    worker_mem: float = 0.0  # bytes; 0 with n_models=1 means "no cache"
    residency_policy: str = "lru"  # eviction: "lru" or "cost_aware"
    sched_cfg: dict = dataclasses.field(default_factory=dict)  # orloj only
    lm_c0: float = 25.0  # Eq.-3 batch latency model of the serving hardware
    lm_c1: float = 1.0
    time_scale: float = 1.0  # Fig. 14: shrink every alone-time uniformly
    charge_overhead: bool = False  # bill decision time to the virtual clock
    # Event-loop RNG seed (dispatch-policy tie-breaks/sampling).  None means
    # "follow the trace seed"; the legacy cluster sweeps pin it separately.
    loop_seed: int | None = None
    tag: str = ""  # display label used by the legacy CSV formatters

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# Fields of ExperimentResult that carry measured wall-clock (or, for
# ``substrate_meta``, profiled hardware constants and measured drift) and
# therefore legitimately differ between two runs of the same spec.
TIMING_FIELDS = frozenset(
    {"sched_time_ms", "sched_us_per_request", "wall_s", "substrate_meta"}
)


@dataclasses.dataclass(frozen=True)
class ExperimentResult:
    spec: ExperimentSpec
    # -- outcome (deterministic given the spec) -----------------------------
    finish_rate: float
    n_total: int
    n_finished_ok: int
    n_finished_late: int
    n_dropped: int
    n_unserved: int
    utilization: float
    makespan_ms: float
    p99_alone_ms: float  # P99 of the set's alone-times (the SLO anchor)
    latency_p50_ms: float
    latency_p99_ms: float
    n_decisions: int
    # -- timing (machine-dependent) -----------------------------------------
    sched_time_ms: float
    sched_us_per_request: float
    wall_s: float
    # -- fault-tier terminal states (outcome fields; zero when no plan;
    # defaulted so pre-fault artifacts still parse — DESIGN.md §11) --------
    n_rejected: int = 0
    n_failed: int = 0
    n_retried: int = 0
    # True when the replay was cut off at ``spec.wall_budget_s`` — partial
    # outcome fields; ordering claims exclude truncated cells.
    truncated: bool = False
    # Token-mode outcome fields (DESIGN.md §12; zero for atomic-batch
    # cells, defaulted so pre-token artifacts still parse).  TTFT is
    # first-token-time minus release; TPOT the per-token rate of the
    # remaining decode (finish − first_token)/(tokens − 1), both over
    # finished requests only.
    ttft_p50_ms: float = 0.0
    ttft_p99_ms: float = 0.0
    tpot_p50_ms: float = 0.0
    tpot_p99_ms: float = 0.0
    n_tokens_out: int = 0
    # Multi-model residency counters (DESIGN.md §13; zero for
    # single-model cells, defaulted so pre-multi-model artifacts still
    # parse).  model_load_ms is virtual stall time — deterministic given
    # the spec, so it stays in stable_dict.
    n_model_loads: int = 0
    n_model_evicts: int = 0
    model_load_ms: float = 0.0
    # Engine-substrate provenance (empty for sim cells): registry model,
    # profiled Eq.-3 constants, predicted-vs-measured batch-time drift, the
    # sim-twin comparison and the finish set (repro.eval.substrate).
    substrate_meta: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["spec"] = self.spec.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentResult":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known and k != "spec"}
        return cls(spec=ExperimentSpec.from_dict(d["spec"]), **kw)

    def stable_dict(self) -> dict[str, Any]:
        """Everything two runs of the same spec must agree on bit-for-bit
        (serial vs parallel execution included)."""
        d = self.to_dict()
        for k in TIMING_FIELDS:
            d.pop(k, None)
        return d
