"""Unified multi-worker discrete-event engine (paper §5 methodology, §3.1
scale-out).

One event loop drives both the single-worker evaluation harness (§5: one
non-preemptive worker executing one batch at a time, ground-truth batch
latency ``l_B = c0 + c1·k·max_r l_r`` per Eq. 3–4) and the replica-pool
setting (§3.1: "different models and their replicas can use ORLOJ in
parallel").  The 1-worker case *is* the classic ``simulate`` loop; the
N-worker case adds a front-end dispatch policy that assigns each arriving
request to a replica scheduler.

Design points, each of which previously existed in only one of the two
diverged copies of this loop:

- **per-worker wake dedup** — a scheduler that returns a wake-up time gets
  at most one *live* ``WAKE`` event per worker: a wake is pushed only when
  it is earlier than the worker's pending wake (a superseded later wake
  lingers in the heap as a no-op until it fires, so the bound is amortized,
  not hard: arrivals + in-flight batches + live wakes + not-yet-fired
  superseded wakes).  The pre-unification cluster loop pushed a wake on
  *every* idle dispatch attempt and flooded the heap under light load;
- **scheduler-overhead charging** — optionally bill the measured wall-clock
  cost of each scheduling decision to the virtual clock (the Fig.-14
  overhead study);
- **horizon** — stop observing at a fixed virtual time: the reported
  makespan is clamped to the horizon, busy time is credited only inside
  the window, and the rest of the trace (including any in-flight batch)
  counts as unserved;
- **heterogeneous replicas** — each :class:`Worker` pairs its own scheduler
  with its own executor, so a pool can mix fast and slow replicas or
  different :class:`~repro.core.distributions.BatchLatencyModel` s;
- **honest accounting** — :class:`SimResult` carries an explicit
  ``n_workers`` and per-pool ``utilization = worker_busy / (makespan ·
  n_workers)`` instead of corrupting ``makespan`` to fake it.

Front-end dispatch policies (pluggable via :data:`DISPATCH_POLICIES` or any
callable ``(request, now, pool) -> worker_index``):

- ``round_robin`` — baseline;
- ``least_loaded`` — fewest pending requests, ties broken randomly (the
  standard full-information serving-tier balancer);
- ``jsq_work`` — least *expected work* queued (Σ per-request E[alone]),
  distribution-aware: reuses the same per-app means ORLOJ tracks;
- ``p2c`` — power-of-two-choices: sample two replicas, send to the one
  with less expected queued work.  Distribution-aware like ``jsq_work``
  but needs only two load probes per arrival, the classic trade-off for
  front-ends that cannot snapshot every replica.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time as _time
from typing import Callable, Protocol, Sequence

import numpy as np

from .distributions import BatchLatencyModel
from .eventwheel import EventWheel
from .request import Request
from .requeststore import RequestStore
from .scheduler import Batch
from .spans import (
    LOOP_RUN,
    SCHED_NEXT_BATCH,
    SCHED_ON_ARRIVAL,
    SCHED_ON_BATCH_DONE,
    SCHED_ON_DECODE_STEP,
    SpanLog,
)

__all__ = [
    "DISPATCH_POLICIES",
    "ENGINES",
    "HOOKS",
    "DecodeExecutorLike",
    "DecodeModelExecutor",
    "Executor",
    "ModelExecutor",
    "SchedulerLike",
    "SimResult",
    "TokenSchedulerLike",
    "Worker",
    "run_event_loop",
    "simulate",
]


class Executor(Protocol):
    def __call__(self, batch: Batch, now: float) -> float:
        """Return the batch execution time in ms."""


class SchedulerLike(Protocol):
    """The contract the event loop drives (Orloj and every baseline).

    ``on_arrivals`` (bulk delivery) is optional — the loop probes for it
    with ``getattr`` and falls back to per-request ``on_arrival``."""

    def on_arrival(self, req: Request, now: float) -> None: ...

    def next_batch(self, now: float) -> tuple[Batch | None, float | None]: ...

    def on_batch_done(
        self, batch: Batch, now: float, alone_times_ms: Sequence[float]
    ) -> None: ...


class TokenSchedulerLike(SchedulerLike, Protocol):
    """The extra hook a token-mode scheduler implements (DESIGN.md §12).

    A scheduler opts into iteration-level (continuous) batching by
    returning ``Batch(decode=True)`` from ``next_batch``.  The loop then
    calls ``on_decode_step`` once per decode iteration — after EOS
    removals, before the next step is armed — and the scheduler answers
    with the requests to admit into the running batch at this token
    boundary (possibly none).  ``on_batch_done`` is never called for
    decode batches."""

    def on_decode_step(
        self, finished: Sequence[Request], n_active: int, now: float
    ) -> list[Request]: ...


class DecodeExecutorLike(Protocol):
    """Executor contract for resumable decode executions.

    ``active`` is the continuous batch *after* this step's joins;
    ``joined`` are the members whose prompt prefill is folded into this
    step (Orca-style piggybacked prefill).  At initial dispatch both are
    the full batch.  Returns the step duration in ms."""

    def step_time(
        self,
        active: Sequence[Request],
        joined: Sequence[Request],
        now: float,
    ) -> float: ...


class FaultPlanLike(Protocol):
    """Duck-typed fault plan (:class:`repro.serving.faults.FaultPlan`).

    The core engine never imports the serving layer — it only needs the
    plan to materialize per-run state with seeded rng streams and the
    gate/retry/straggler hooks the loops call."""

    @property
    def restart_delay_ms(self) -> float: ...

    @property
    def admission_floor(self) -> float: ...

    @property
    def batch_timeout_ms(self) -> float: ...

    def enabled(self) -> bool: ...

    def start(self, n_workers: int) -> "FaultStateLike": ...


class FaultStateLike(Protocol):
    plan: "FaultPlanLike"
    crashes: bool

    def next_crash(self, w: int, up_since: float) -> float: ...

    def straggle(self, dur: float) -> float: ...

    def admit(
        self,
        scheduler: "SchedulerLike",
        req: Request,
        now: float,
        queued_ahead: int = 0,
    ) -> bool: ...

    def retry_decision(
        self, scheduler: "SchedulerLike", req: Request, now: float
    ) -> tuple[bool, float]: ...


class ResidencyPlanLike(Protocol):
    """Duck-typed weights-residency plan
    (:class:`repro.serving.residency.ResidencyPlan`).  As with faults, the
    core engine never imports the serving layer — it only needs
    ``start(n_workers)`` to mint the per-run cache state."""

    def start(self, n_workers: int) -> "ResidencyStateLike": ...


class ResidencyStateLike(Protocol):
    """Per-run residency state: deterministic (no rng, virtual time only),
    so both engines charging the same dispatch order stay bit-identical."""

    n_loads: int
    n_evicts: int
    load_ms_total: float

    def resident(self, w: int, model_id: str) -> bool: ...

    def acquire(self, w: int, model_id: str, now: float) -> float: ...


@dataclasses.dataclass
class ModelExecutor:
    """Ground-truth execution following the paper's padding model."""

    latency_model: BatchLatencyModel
    jitter: float = 0.0  # multiplicative noise std (hardware non-determinism)
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def __call__(self, batch: Batch, now: float) -> float:
        t = self.latency_model.batch_time([r.true_time for r in batch.requests])
        if self.jitter > 0:
            t *= float(np.exp(self._rng.normal(0.0, self.jitter)))
        return t


@dataclasses.dataclass
class DecodeModelExecutor:
    """Ground-truth token-level execution (the Eq.-3 analogue per decode
    iteration): one step over a continuous batch of ``k`` requests costs
    ``d0 + d1·k`` ms (every member produces one token; max_r l_r is one
    token-time), plus ``prefill_per_token`` ms for each prompt token of
    the members whose prefill piggybacks on this step — the concrete
    source of prefill/decode interference.  Deterministic by construction,
    so both engines replay identical step timestamps."""

    d0: float = 2.0
    d1: float = 0.25
    prefill_per_token: float = 0.02

    def step_time(
        self,
        active: Sequence[Request],
        joined: Sequence[Request],
        now: float,
    ) -> float:
        t = self.d0 + self.d1 * len(active)
        if joined:
            t += self.prefill_per_token * sum(r.prompt_tokens for r in joined)
        return t

    def __call__(self, batch: Batch, now: float) -> float:
        raise TypeError(
            "DecodeModelExecutor serves resumable decode batches only; "
            "atomic batches need a ModelExecutor"
        )


class _DecodeRun:
    """Mutable state of one resumable decode execution — one per
    dispatched ``decode=True`` batch, threaded through the re-armed
    ``_STEP`` events.  ``rows`` (array engine only) tracks each active
    request's store row, aligned with ``active``."""

    __slots__ = ("batch", "active", "rows")

    def __init__(
        self, batch: Batch, active: list[Request], rows: list[int] | None
    ) -> None:
        self.batch = batch
        self.active = active
        self.rows = rows


def _advance_decode(
    run: _DecodeRun, now: float
) -> tuple[list[Request], list[int]]:
    """Advance every active request by one produced token and split off
    those hitting EOS this step.  The single token-accounting path both
    engines share, so ``tokens_done``/``first_token``/EOS timestamps are
    bit-identical by construction.  Returns ``(finished, finished_rows)``;
    rows are tracked only when the run carries them (array engine)."""
    rows = run.rows
    finished: list[Request] = []
    fin_rows: list[int] = []
    still: list[Request] = []
    still_rows: list[int] = []
    for i, r in enumerate(run.active):
        r.tokens_done += 1
        if r.first_token is None:
            r.first_token = now
        if r.tokens_done >= r.out_tokens:
            finished.append(r)
            if rows is not None:
                fin_rows.append(rows[i])
        else:
            still.append(r)
            if rows is not None:
                still_rows.append(rows[i])
    run.active = still
    if rows is not None:
        run.rows = still_rows
    return finished, fin_rows


def _decode_step_dur(
    executor: Executor,
    active: Sequence[Request],
    joined: Sequence[Request],
    now: float,
) -> float:
    """One decode-step duration via the executor's ``step_time`` hook,
    with an actionable error for executors that only run atomic batches."""
    step = getattr(executor, "step_time", None)
    if step is None:
        raise TypeError(
            f"scheduler returned a decode batch but executor "
            f"{type(executor).__name__} has no step_time (token mode "
            f"needs a DecodeExecutorLike, e.g. DecodeModelExecutor)"
        )
    return step(active, joined, now)


@dataclasses.dataclass
class SimResult:
    n_total: int
    n_finished_ok: int
    n_finished_late: int
    n_dropped: int
    n_unserved: int
    worker_busy: float  # summed busy time across the pool
    makespan_ms: float  # virtual time (ms) of the last processed event
    latencies: np.ndarray
    n_workers: int = 1
    peak_heap_size: int = 0  # high-water mark of the event heap
    # Measured wall-clock spent inside scheduler hooks (``on_arrival(s)``,
    # ``next_batch``, ``on_batch_done``), separated from the simulation's
    # own bookkeeping so per-request overhead columns charge the scheduler
    # for its decisions only — not for the event loop that replays them.
    sched_time_ms: float = 0.0
    n_decisions: int = 0  # number of ``next_batch`` calls
    # Batches actually executed (DONE events inside the horizon).  The
    # real-engine eval tier pairs this with the executor's measured-batch
    # log to attribute predicted-vs-measured drift per executed batch.
    n_batches: int = 0
    # Fault-tier terminal-state accounting (DESIGN.md §11): admission
    # rejections, retry-exhausted failures after crash/timeout aborts,
    # and the total number of retry dispatches (a request retried twice
    # counts twice).
    n_rejected: int = 0
    n_failed: int = 0
    n_retried: int = 0
    # True when the run was cut off by ``wall_budget_s`` — partial stats,
    # everything unresolved counted as unserved.
    truncated: bool = False
    # Multi-model residency accounting (DESIGN.md §13): weight loads,
    # evictions, and the total virtual ms of load/evict stall charged to
    # the clock.  All zero when no residency plan is active.
    n_model_loads: int = 0
    n_model_evicts: int = 0
    model_load_ms: float = 0.0
    # ``sched_time_ms`` split by hook (the keys of :data:`HOOKS`; they sum
    # to it, ``on_decode_step`` included), and each hook's calls:
    # ``on_arrival`` counts every request delivered, in bulk too, and
    # ``next_batch`` plus ``on_decode_step`` make ``n_decisions``.  With
    # ``charge_scheduler_overhead`` only ``next_batch`` is charged.
    hook_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    hook_calls: dict[str, int] = dataclasses.field(default_factory=dict)
    # The span log the run recorded into, when the caller passed one.
    spans: SpanLog | None = None

    @property
    def conserved(self) -> bool:
        """Hard conservation invariant: every request reaches exactly one
        terminal state — finished (ok|late), dropped, rejected, failed —
        or none (unserved).  The fault tier property-tests this across
        engines and fleet mode."""
        return (
            self.n_finished_ok + self.n_finished_late + self.n_dropped
            + self.n_unserved + self.n_rejected + self.n_failed
            == self.n_total
        )

    @property
    def sched_us_per_request(self) -> float:
        """Scheduler decision time per request (µs) — the overhead column."""
        return self.sched_time_ms * 1e3 / max(1, self.n_total)

    @property
    def finish_rate(self) -> float:
        return self.n_finished_ok / max(1, self.n_total)

    @property
    def utilization(self) -> float:
        """Pool utilization: busy time over total worker-time available."""
        return self.worker_busy / max(self.makespan_ms * self.n_workers, 1e-9)

    def summary(self) -> str:
        return (
            f"finish_rate={self.finish_rate:.3f} ok={self.n_finished_ok} "
            f"late={self.n_finished_late} dropped={self.n_dropped} "
            f"unserved={self.n_unserved} util={self.utilization:.2f}"
        )


@dataclasses.dataclass
class Worker:
    """One replica: its scheduler plus the executor that runs its batches.

    Executors may be shared between workers (homogeneous pool, one measured
    backend) or distinct (heterogeneous pool of fast/slow replicas)."""

    scheduler: SchedulerLike
    executor: Executor


def _expected_alone(scheduler: SchedulerLike, req: Request) -> float:
    """E[alone] of ``req`` under the scheduler's learned app distribution
    (falls back to its scalar estimator, then to a unit cost)."""
    dists = getattr(scheduler, "_app_dists", None)
    if dists and req.app_id in dists:
        return float(dists[req.app_id].mean())
    est = getattr(scheduler, "est", None)
    if est is not None:
        return float(est.value())
    return 1.0


class _Pool:
    """Dispatch-time view of the pool handed to policy callables.

    ``queued_work`` is an incremental ledger of per-request charges
    (E[alone] under the scheduler's app distribution *at arrival time*).
    Each charge is recorded per rid and the **same recorded value** is
    subtracted when the request leaves — never re-evaluated, since the
    scheduler may swap in a new profiler snapshot in between and a
    re-evaluated decrement would make the ledger drift (even negative).
    Requests the scheduler drops are swept from the ledger lazily after
    each scheduling decision.

    The ledger is maintained only when ``track_work`` — i.e. when the
    dispatch policy actually reads ``queued_work`` (``jsq_work``, ``p2c``,
    or any user callable); count-based policies and 1-worker runs skip the
    bookkeeping entirely."""

    __slots__ = ("workers", "busy", "queued_work", "rng", "track_work",
                 "pending_offset", "_charges", "_swept_timeouts", "residency")

    def __init__(
        self,
        workers: Sequence[Worker],
        rng: np.random.Generator,
        track_work: bool = True,
    ):
        self.workers = list(workers)
        self.busy = [False] * len(self.workers)
        self.queued_work = [0.0] * len(self.workers)
        # Weights-residency state (multi-model runs only, DESIGN.md §13):
        # set by run_event_loop so residency-aware dispatch policies can
        # probe which workers hold a request's model.  None otherwise.
        self.residency: "ResidencyStateLike | None" = None
        # Same-timestamp arrivals routed to a worker but not yet delivered
        # to its scheduler (the coalescing window): count-based policies add
        # this so a burst does not all land on one replica.
        self.pending_offset = [0] * len(self.workers)
        self.rng = rng
        self.track_work = track_work
        # per-worker rid -> (request, charged amount)
        self._charges: list[dict[int, tuple[Request, float]]] = [
            {} for _ in self.workers
        ]
        # per-worker scheduler timeout count at the last sweep
        self._swept_timeouts = [0] * len(self.workers)

    def __len__(self) -> int:
        return len(self.workers)

    def charge(self, w: int, req: Request) -> None:
        if not self.track_work:
            return
        amount = _expected_alone(self.workers[w].scheduler, req)
        self._charges[w][req.rid] = (req, amount)
        self.queued_work[w] += amount

    def discharge(self, w: int, rid: int) -> None:
        if not self.track_work:
            return
        got = self._charges[w].pop(rid, None)
        if got is not None:
            self.queued_work[w] -= got[1]

    def sweep_dropped(self, w: int) -> None:
        """Remove charges for requests the scheduler timed out (they will
        never be dispatched, so nothing else would ever discharge them).
        Scans only when the scheduler's timeout counter moved since the
        last sweep (schedulers without a counter are always scanned)."""
        if not self.track_work:
            return
        n_timed_out = getattr(self.workers[w].scheduler, "n_timed_out", None)
        if n_timed_out is not None:
            if n_timed_out == self._swept_timeouts[w]:
                return
            self._swept_timeouts[w] = n_timed_out
        ch = self._charges[w]
        stale = [rid for rid, (req, _) in ch.items() if req.dropped is not None]
        for rid in stale:
            self.queued_work[w] -= ch.pop(rid)[1]

    def backlog(self, w: int) -> tuple[float, float]:
        """(expected queued work, queue length) — the policy sort key."""
        sched = self.workers[w].scheduler
        return (
            self.queued_work[w],
            getattr(sched, "n_pending", 0) + self.busy[w]
            + self.pending_offset[w],
        )


# A dispatch policy: (request, now, pool) -> worker index.
_PickFn = Callable[[Request, float, _Pool], int]


def _round_robin(workers: Sequence[Worker], rng: np.random.Generator) -> _PickFn:
    it = itertools.cycle(range(len(workers)))
    return lambda req, now, pool: next(it)


def _least_loaded(workers: Sequence[Worker], rng: np.random.Generator) -> _PickFn:
    def pick(req: Request, now: float, pool: _Pool) -> int:
        loads = np.array(
            [
                getattr(w.scheduler, "n_pending", 0) + pool.busy[i]
                + pool.pending_offset[i]
                for i, w in enumerate(pool.workers)
            ]
        )
        cands = np.flatnonzero(loads == loads.min())
        return int(rng.choice(cands))

    return pick


def _jsq_work(workers: Sequence[Worker], rng: np.random.Generator) -> _PickFn:
    return lambda req, now, pool: int(np.argmin(pool.queued_work))


def _p2c(workers: Sequence[Worker], rng: np.random.Generator) -> _PickFn:
    n = len(workers)

    def pick(req: Request, now: float, pool: _Pool) -> int:
        if n == 1:
            return 0
        i, j = rng.choice(n, size=2, replace=False)
        return int(i) if pool.backlog(int(i)) <= pool.backlog(int(j)) else int(j)

    return pick


def _residency_aware(
    workers: Sequence[Worker], rng: np.random.Generator
) -> _PickFn:
    """Residency before backlog (DESIGN.md §13): among workers already
    holding the request's model weights, pick the least loaded; only when
    nobody holds them fall back to least-loaded overall.  The fallback
    creates natural model→worker affinity — once a model is loaded
    somewhere, its traffic sticks there instead of spraying cold starts
    across the pool the way residency-blind policies do.  Fully
    deterministic (ties break on worker index, no rng), so the policy
    cannot perturb engine bit-identity."""

    def pick(req: Request, now: float, pool: _Pool) -> int:
        res = pool.residency
        best, best_key = 0, None
        for i, w in enumerate(pool.workers):
            load = (
                getattr(w.scheduler, "n_pending", 0) + pool.busy[i]
                + pool.pending_offset[i]
            )
            hit = (
                res is not None
                and req.model_id is not None
                and res.resident(i, req.model_id)
            )
            key = (not hit, load, i)  # resident first, then backlog
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    return pick


# name -> factory(workers, rng) -> pick(request, now, pool) -> worker index
DISPATCH_POLICIES: dict[str, Callable] = {
    "round_robin": _round_robin,
    "least_loaded": _least_loaded,
    "jsq_work": _jsq_work,
    "p2c": _p2c,
    "residency": _residency_aware,
}

_ARRIVAL, _DONE, _WAKE = 0, 1, 2
# Fault-tier event kinds (DESIGN.md §11): worker crash / worker restart /
# deadline-aware retry of an aborted request / batch-timeout abort.
_CRASH, _RESTART, _RETRY, _ABORT = 3, 4, 5, 6
# Token-mode event kind (DESIGN.md §12): one decode iteration of a
# resumable execution — a DONE that may re-arm itself.
_STEP = 7

# Array-loop merge sources (where the next dynamic event comes from).
_TAKE_BUF, _TAKE_BUCKET, _TAKE_ONE = 1, 2, 3
_NO_EVENT = (math.inf, -1)

# Event-loop implementations.  ``scalar`` is the original heapq loop and
# stays the oracle; ``array`` is the array-backed engine (RequestStore +
# EventWheel, DESIGN.md §10) whose observable behaviour — every scheduler
# hook call, timestamp, rng draw and result field — is bit-identical to
# the oracle (regression-tested over the full small grid).
ENGINES = ("scalar", "array")

# The scheduler hooks the loops meter, the keys of ``SimResult.hook_ms`` and
# ``hook_calls``, and the span each is recorded as in a :class:`SpanLog`.
HOOKS = ("next_batch", "on_arrival", "on_batch_done", "on_decode_step")
_NEXT_BATCH, _ON_ARRIVAL, _ON_BATCH_DONE, _ON_DECODE_STEP = range(4)
_HOOK_SPANS = (SCHED_NEXT_BATCH, SCHED_ON_ARRIVAL, SCHED_ON_BATCH_DONE, SCHED_ON_DECODE_STEP)


def run_event_loop(
    requests: Sequence[Request],
    workers: Sequence[Worker],
    *,
    policy: str | Callable = "least_loaded",
    horizon: float | None = None,
    charge_scheduler_overhead: bool = False,
    seed: int = 0,
    engine: str = "scalar",
    faults: "FaultPlanLike | None" = None,
    residency: "ResidencyPlanLike | None" = None,
    wall_budget_s: float = 0.0,
    spans: SpanLog | None = None,
) -> SimResult:
    """Drive ``workers`` replica schedulers against one arrival stream.

    Runs until every request is resolved (finished/dropped) or, with
    ``horizon``, until the virtual clock passes it.  ``policy`` is a name
    from :data:`DISPATCH_POLICIES` or a callable
    ``(request, now, pool) -> worker_index``.

    Custom callables should measure load via ``pool.backlog(w)`` (or add
    ``pool.pending_offset[w]`` to any direct ``n_pending`` read): during a
    coalesced same-timestamp burst, arrivals routed to a busy worker are
    buffered and only delivered to its scheduler after routing, so its raw
    ``n_pending`` lags by the buffered count.

    ``charge_scheduler_overhead=True`` bills the *measured wall-clock* cost
    of each scheduler decision to the virtual clock (used by the Fig.-14
    overhead study: with ms-scale requests, scheduling time itself starts
    to matter).

    ``engine`` picks the implementation (:data:`ENGINES`): ``"scalar"`` is
    the original heapq loop (the oracle); ``"array"`` sources arrivals from
    a :class:`~repro.core.requeststore.RequestStore` and DONE/WAKE events
    from an :class:`~repro.core.eventwheel.EventWheel` — same observable
    behaviour, built for 10⁵–10⁶-request traces.  ``peak_heap_size`` is the
    one intentionally engine-specific field: both report peak *pending
    events*, but the scalar heap retains superseded-wake tombstones
    slightly differently than the wheel, so only the bound (not the exact
    value) is comparable.

    ``faults`` is an optional :class:`~repro.serving.faults.FaultPlan`
    (anything exposing ``start(n_workers)``): worker crashes, stragglers,
    admission control and batch timeouts, replayed identically by both
    engines from the plan's own seeded rng streams (DESIGN.md §11).
    ``wall_budget_s > 0`` cuts the run off after that much *wall-clock*
    time: the result is marked ``truncated`` and everything unresolved
    counts as unserved — a graceful partial answer instead of a hung grid
    cell.

    ``residency`` is an optional
    :class:`~repro.serving.residency.ResidencyPlan`: per-worker weights
    caches for multi-model serving (DESIGN.md §13).  Every dispatched
    batch must then carry ``Batch.model``; a cache miss stalls execution
    by the model's load time (plus eviction costs), charged identically
    by both engines.  ``residency=None`` (every single-model run) takes
    zero new branches — the ``single-model-noop`` claim gates this
    bitwise.  Residency composes with neither fault injection nor decode
    batches (both raise ``ValueError``, the pinned unsupported seams).

    ``spans`` is an optional :class:`~repro_torch.core.spans.SpanLog`: the
    scalar loop then records each scheduler hook call as a span (the
    ``next_batch`` span carries the dispatched batch's size), the loop
    itself as ``loop.run``, and each dispatched request's wait in its
    ``queue_wait_ms``, and returns the log as ``SimResult.spans``.  The
    array engine refuses a span log (``ValueError``).  Without one the
    loops meter each hook into ``SimResult.hook_ms``/``hook_calls`` alone.
    """
    workers = list(workers)
    if not workers:
        raise ValueError("need at least one worker")
    n = len(workers)
    rng = np.random.default_rng(seed)
    # Only work-aware policies read queued_work; 1-worker runs and
    # count-based policies skip the ledger bookkeeping entirely.
    track_work = n > 1 and (callable(policy) or policy in ("jsq_work", "p2c"))
    pool = _Pool(workers, rng, track_work=track_work)
    if callable(policy):
        pick = policy
    else:
        try:
            pick = DISPATCH_POLICIES[policy](workers, rng)
        except KeyError:
            raise ValueError(
                f"unknown dispatch policy {policy!r}; "
                f"known: {sorted(DISPATCH_POLICIES)}"
            ) from None
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; known: {list(ENGINES)}"
        )
    if spans is not None and engine == "array":
        raise ValueError(
            "span logs are not supported by the array engine"
        )
    if residency is not None and faults is not None:
        # Crash-during-load semantics (is a half-loaded model resident?
        # does the stall replay after restart?) have no honest answer yet;
        # fail loudly rather than charge something undefined.
        raise ValueError(
            "multi-model residency is not supported under fault injection"
        )
    res = residency.start(n) if residency is not None else None
    pool.residency = res
    fs = faults.start(n) if faults is not None else None
    if fs is not None and (fs.crashes or fs.plan.batch_timeout_ms > 0.0):
        # Crash termination leans on every scheduler's drop counter to
        # decide whether unresolved work remains (all in-repo schedulers
        # expose it); refuse silently-wrong accounting up front.
        for w_ in workers:
            if getattr(w_.scheduler, "n_timed_out", None) is None:
                raise ValueError(
                    "fault injection (crashes/batch timeouts) requires "
                    "schedulers exposing n_timed_out"
                )
    if engine == "array":
        return _array_loop(
            requests,
            workers,
            pool,
            pick,
            horizon=horizon,
            charge_scheduler_overhead=charge_scheduler_overhead,
            fs=fs,
            res=res,
            wall_budget_s=wall_budget_s,
        )

    requests = sorted(requests, key=lambda r: r.release)
    events: list[tuple[float, int, int, object]] = []
    seq = itertools.count()
    for r in requests:
        heapq.heappush(events, (r.release, next(seq), _ARRIVAL, r))

    plan = fs.plan if fs is not None else None
    n_rejected = 0
    n_failed = 0
    n_retried = 0
    n_finished = 0
    truncated = False
    down = [False] * n
    # Per-worker crash epoch: a DONE/ABORT event carries the epoch its
    # batch was dispatched under; a crash bumps the epoch so the stale
    # completion becomes a tombstone when it fires.
    epoch = [0] * n
    # In-flight batch payloads, maintained only under a fault plan (the
    # crash-abort path needs the batch; ``inflight`` keeps only spans).
    running: list[Batch | None] = [None] * n
    gate = plan is not None and plan.admission_floor > 0.0
    timeout_ms = plan.batch_timeout_ms if plan is not None else 0.0
    if fs is not None and fs.crashes:
        # initial crash draws, one per worker in index order (the array
        # loop mirrors this exactly, so seq numbers line up)
        for w in range(n):
            heapq.heappush(
                events, (fs.next_crash(w, 0.0), next(seq), _CRASH, w)
            )

    peak_heap = len(events)
    worker_busy_time = 0.0
    hook_s = [0.0] * len(HOOKS)  # wall-clock seconds inside each scheduler hook
    hook_n = [0] * len(HOOKS)
    n_decisions = 0
    n_batches = 0
    last_time = 0.0
    inflight: list[tuple[float, float] | None] = [None] * n  # (start, end)
    # At most one *live* WAKE per worker (re-armed only for an earlier
    # wake): the dedup that keeps the heap from flooding under light load.
    pending_wake: list[float | None] = [None] * n

    def metered(hook: int, dt: float, n: int = 1) -> None:
        hook_s[hook] += dt
        hook_n[hook] += n
        if spans is not None:
            spans.close(_HOOK_SPANS[hook], dt)

    def try_dispatch(w: int, now: float) -> None:
        nonlocal worker_busy_time, peak_heap, n_decisions
        if pool.busy[w] or down[w]:
            return
        worker = workers[w]
        # simlint: ignore[R1] -- meters real scheduler overhead (reported, optionally charged as latency); the sim clock itself stays virtual
        t0 = _time.perf_counter()
        batch, wake = worker.scheduler.next_batch(now)
        # simlint: ignore[R1] -- closes the overhead meter opened above
        dt = _time.perf_counter() - t0
        hook_s[_NEXT_BATCH] += dt
        hook_n[_NEXT_BATCH] += 1
        n_decisions += 1
        if spans is not None:
            spans.close(SCHED_NEXT_BATCH, dt, 0 if batch is None else len(batch.requests))
        overhead = dt * 1e3 if charge_scheduler_overhead else 0.0
        if batch is not None and getattr(batch, "decode", False):
            # Resumable token-level execution (DESIGN.md §12): the dispatch
            # step prefills every initial member and produces their first
            # token; the run then re-arms _STEP events until the last
            # member hits EOS.
            if fs is not None:
                raise ValueError(
                    "decode (token-level) batches are not supported "
                    "under fault injection"
                )
            if res is not None:
                raise ValueError(
                    "decode (token-level) batches are not supported "
                    "under multi-model residency"
                )
            start = now + overhead
            run = _DecodeRun(batch, list(batch.requests), None)
            dur = _decode_step_dur(
                worker.executor, run.active, batch.requests, start
            )
            for r in batch.requests:
                r.started = start
                pool.discharge(w, r.rid)
            if spans is not None:
                spans.waited(batch.requests, start)
            pool.busy[w] = True
            worker_busy_time += dur
            inflight[w] = (start, start + dur)
            heapq.heappush(
                events, (start + dur, next(seq), _STEP, (w, run, epoch[w]))
            )
            peak_heap = max(peak_heap, len(events))
        elif batch is not None:
            start = now + overhead
            if res is not None:
                # Weights residency (DESIGN.md §13): a cache miss stalls
                # the batch by the load time (plus eviction costs) before
                # execution can begin.  The worker is occupied for the
                # whole stall — loads are not overlapped with compute.
                if batch.model is None:
                    raise ValueError(
                        "residency-managed run dispatched a batch without "
                        "a model id (scheduler must stamp Batch.model)"
                    )
                stall = res.acquire(w, batch.model, start)
                start += stall
            else:
                stall = 0.0
            dur = worker.executor(batch, start)
            ev_kind = _DONE
            if fs is not None:
                dur = fs.straggle(dur)
                if 0.0 < timeout_ms < dur:
                    # overlong batch: aborted at the timeout deadline,
                    # its requests go through the retry gate
                    dur = timeout_ms
                    ev_kind = _ABORT
                running[w] = batch
            for r in batch.requests:
                r.started = start
                pool.discharge(w, r.rid)
            if spans is not None:
                spans.waited(batch.requests, start)
            pool.busy[w] = True
            worker_busy_time += stall + dur
            inflight[w] = (start - stall, start + dur)
            heapq.heappush(
                events, (start + dur, next(seq), ev_kind, (w, batch, epoch[w]))
            )
            peak_heap = max(peak_heap, len(events))
        elif wake is not None and np.isfinite(wake) and wake > now:
            if pending_wake[w] is None or wake < pending_wake[w]:
                pending_wake[w] = wake
                heapq.heappush(events, (wake, next(seq), _WAKE, w))
                peak_heap = max(peak_heap, len(events))
        # the decision may have timed requests out (drop phase) — keep the
        # policy load signal honest
        pool.sweep_dropped(w)

    def work_remains() -> bool:
        # Any request without a terminal state yet, arrived or not.  A
        # crash/restart only reschedules itself while this holds, so the
        # renewal process cannot keep an otherwise-drained loop alive.
        resolved = n_finished + n_rejected + n_failed
        for w_ in workers:
            resolved += w_.scheduler.n_timed_out  # type: ignore[attr-defined]
        return resolved < len(requests)

    def abort_batch(w: int, batch: Batch, now: float) -> None:
        # Crash/timeout abort: each request re-enters through the
        # deadline-aware retry gate or terminates honestly as failed.
        nonlocal n_failed, n_retried, peak_heap
        assert fs is not None
        sched = workers[w].scheduler
        for r in batch.requests:
            r.started = None
            retry, t_retry = fs.retry_decision(sched, r, now)
            if retry:
                r.retries += 1
                n_retried += 1
                heapq.heappush(events, (t_retry, next(seq), _RETRY, r))
            else:
                r.failed = now
                n_failed += 1
        peak_heap = max(peak_heap, len(events))

    wall_deadline = None
    if wall_budget_s > 0.0:
        # simlint: ignore[R1] -- wall-budget truncation is real elapsed time by design; the sim clock stays virtual
        wall_deadline = _time.perf_counter() + wall_budget_s
    n_events = 0
    # simlint: ignore[R1] -- stamps the loop's span on the device trace's clock; the sim clock stays virtual
    run_start = _time.time_ns() if spans is not None else 0
    while events:
        now, _, kind, payload = heapq.heappop(events)
        n_events += 1
        if (
            wall_deadline is not None
            and not n_events & 1023
            # simlint: ignore[R1] -- wall-budget truncation check (real elapsed time by design)
            and _time.perf_counter() > wall_deadline
        ):
            # Out of wall-clock budget: stop observing at the last
            # processed event (the popped one is discarded unprocessed),
            # clamp in-flight busy credit exactly like the horizon path,
            # and report the partial stats as ``truncated``.
            truncated = True
            for span in inflight:
                if span is not None and span[1] > last_time:
                    worker_busy_time -= span[1] - max(span[0], last_time)
            break
        if horizon is not None and now > horizon:
            # Stop observing at the horizon: the clock reads ``horizon``
            # (not the time of the first event beyond it) and busy time is
            # only credited for work inside the window — an in-flight
            # batch's requests stay unserved, so crediting its full
            # duration would overstate utilization.
            last_time = horizon
            for span in inflight:
                if span is not None and span[1] > horizon:
                    worker_busy_time -= span[1] - max(span[0], horizon)
            break
        last_time = now
        if kind == _ARRIVAL:
            # Coalesce every arrival bearing this exact timestamp (a burst
            # drained from the network in one go).  While a worker is idle
            # its share is delivered one request at a time with a dispatch
            # attempt in between — identical to the pre-coalescing loop, so
            # an urgent head-of-burst request can still grab the idle
            # worker.  The moment the worker goes busy (the high-load hot
            # path) the rest of the burst is delivered as ONE bulk
            # ``on_arrivals`` call and scored in a single vectorized pass.
            # simlint: ignore[R5] -- one burst buffer per ARRIVAL event; the coalescing is what enables the bulk on_arrivals path
            arrivals: list[Request] = [payload]
            while events and events[0][0] == now and events[0][2] == _ARRIVAL:
                arrivals.append(heapq.heappop(events)[3])
            # Route/deliver in arrival order, exactly as the pre-coalescing
            # loop did: an arrival routed to an IDLE worker is delivered and
            # dispatched immediately (so an urgent head-of-burst request can
            # grab the worker, and later picks see the dispatch's busy/
            # discharge side effects).  Only arrivals routed to a BUSY
            # worker — where a dispatch attempt would be a no-op anyway —
            # are buffered and flushed as ONE bulk ``on_arrivals`` call,
            # the high-load case where the vectorized scoring pass pays.
            # ``pending_offset`` keeps count-based policies seeing buffered
            # requests as if they were already delivered.
            # simlint: ignore[R5] -- one routing buffer per burst, replacing per-request scheduler calls with one bulk delivery per worker
            buffered: dict[int, list[Request]] = {}
            for req in arrivals:
                w = pick(req, now, pool) if n > 1 else 0
                if gate and not fs.admit(
                    workers[w].scheduler,
                    req,
                    now,
                    # requests ahead on the picked worker: its queue, the
                    # burst share buffered for it, and the in-flight batch
                    getattr(workers[w].scheduler, "n_pending", 0)
                    + pool.pending_offset[w]
                    + (1 if pool.busy[w] else 0),
                ):
                    # shed at the front door: never queued, never charged
                    # (the pick above still ran, so the policy rng stream
                    # is identical with the gate on or off)
                    req.rejected = now
                    n_rejected += 1
                    continue
                pool.charge(w, req)
                if pool.busy[w]:
                    # simlint: ignore[R5] -- group list created once per (burst, worker), not per request
                    buffered.setdefault(w, []).append(req)
                    pool.pending_offset[w] += 1
                else:
                    t0 = _time.perf_counter()  # simlint: ignore[R1] -- overhead meter, not sim time
                    workers[w].scheduler.on_arrival(req, now)
                    metered(_ON_ARRIVAL, _time.perf_counter() - t0)  # simlint: ignore[R1] -- overhead meter, not sim time
                    try_dispatch(w, now)
            for w, group in buffered.items():
                pool.pending_offset[w] = 0
                sched = workers[w].scheduler
                deliver = getattr(sched, "on_arrivals", None)
                t0 = _time.perf_counter()  # simlint: ignore[R1] -- overhead meter, not sim time
                if deliver is not None:
                    deliver(group, now)
                else:
                    for req in group:
                        sched.on_arrival(req, now)
                metered(_ON_ARRIVAL, _time.perf_counter() - t0, len(group))  # simlint: ignore[R1] -- overhead meter, not sim time
        elif kind == _DONE:
            w, batch, ep = payload
            if ep != epoch[w]:
                continue  # tombstone: the worker crashed under this batch
            pool.busy[w] = False
            inflight[w] = None
            if fs is not None:
                running[w] = None
            n_batches += 1
            n_finished += len(batch.requests)
            for r in batch.requests:
                r.finished = now
            t0 = _time.perf_counter()  # simlint: ignore[R1] -- overhead meter, not sim time
            workers[w].scheduler.on_batch_done(
                # simlint: ignore[R5] -- one alone-times list per completed batch (feedback path), not per request
                batch, now, [r.true_time for r in batch.requests]
            )
            metered(_ON_BATCH_DONE, _time.perf_counter() - t0)  # simlint: ignore[R1] -- overhead meter, not sim time
            try_dispatch(w, now)
        elif kind == _STEP:
            # One decode iteration of a resumable execution: advance token
            # counts, retire EOS requests, let the scheduler admit joiners
            # at this token boundary, then re-arm (or drain the run).
            w, run, ep = payload
            if ep != epoch[w]:
                continue  # tombstone (decode runs never coexist with faults today, but keep the contract uniform)
            finished, _ = _advance_decode(run, now)
            n_finished += len(finished)
            for r in finished:
                r.finished = now
            t0 = _time.perf_counter()  # simlint: ignore[R1] -- overhead meter, not sim time
            joined = workers[w].scheduler.on_decode_step(
                finished, len(run.active), now
            )
            metered(_ON_DECODE_STEP, _time.perf_counter() - t0)  # simlint: ignore[R1] -- overhead meter, not sim time
            n_decisions += 1
            if joined:
                for r in joined:
                    r.started = now
                    pool.discharge(w, r.rid)
                run.active.extend(joined)
            if run.active:
                dur = _decode_step_dur(
                    workers[w].executor, run.active, joined, now
                )
                worker_busy_time += dur
                inflight[w] = (now, now + dur)
                heapq.heappush(
                    events, (now + dur, next(seq), _STEP, (w, run, ep))
                )
                peak_heap = max(peak_heap, len(events))
            else:
                n_batches += 1
                pool.busy[w] = False
                inflight[w] = None
                try_dispatch(w, now)
            # the admission hook may also have timed requests out
            pool.sweep_dropped(w)
        elif kind == _WAKE:
            w = payload
            if pending_wake[w] is not None and now >= pending_wake[w]:
                pending_wake[w] = None
            try_dispatch(w, now)
        elif kind == _ABORT:
            w, batch, ep = payload
            if ep != epoch[w]:
                continue  # the worker crashed before the timeout fired
            pool.busy[w] = False
            inflight[w] = None
            running[w] = None
            abort_batch(w, batch, now)
            try_dispatch(w, now)
        elif kind == _CRASH:
            w = payload
            if work_remains():
                # Kill the worker: bump its epoch (outstanding DONE/ABORT
                # events become tombstones), abort any in-flight batch,
                # schedule the restart.  With no work left the crash is
                # discarded and nothing is rescheduled, so the heap
                # drains and the loop terminates.
                epoch[w] += 1
                down[w] = True
                span = inflight[w]
                if span is not None:
                    # credit only the work actually done before the crash
                    worker_busy_time -= span[1] - max(span[0], now)
                    inflight[w] = None
                    pool.busy[w] = False
                    doomed = running[w]
                    running[w] = None
                    assert doomed is not None
                    abort_batch(w, doomed, now)
                heapq.heappush(
                    events,
                    (now + plan.restart_delay_ms, next(seq), _RESTART, w),
                )
                peak_heap = max(peak_heap, len(events))
        elif kind == _RESTART:
            w = payload
            down[w] = False
            if work_remains():
                heapq.heappush(
                    events, (fs.next_crash(w, now), next(seq), _CRASH, w)
                )
                peak_heap = max(peak_heap, len(events))
            try_dispatch(w, now)
        else:  # _RETRY
            req = payload
            w = pick(req, now, pool) if n > 1 else 0
            if down[w]:
                # Dead-target re-route: deterministically drain to the
                # next live sibling (fleet mode — a dead pool's requeued
                # work flows across pool boundaries).  All-dead keeps the
                # original target: it queues and the restart drains it.
                for k in range(1, n):
                    w2 = (w + k) % n
                    if not down[w2]:
                        w = w2
                        break
            pool.charge(w, req)
            t0 = _time.perf_counter()  # simlint: ignore[R1] -- overhead meter, not sim time
            workers[w].scheduler.on_arrival(req, now)
            metered(_ON_ARRIVAL, _time.perf_counter() - t0)  # simlint: ignore[R1] -- overhead meter, not sim time
            try_dispatch(w, now)
    if spans is not None:
        spans.add(LOOP_RUN, run_start, _time.time_ns())  # simlint: ignore[R1] -- closes the loop's span opened above

    ok = sum(1 for r in requests if r.ok)
    late = sum(1 for r in requests if r.finished is not None and not r.ok)
    dropped = sum(1 for r in requests if r.dropped is not None)
    # Unserved = no terminal state at all; scanned (not derived) so the
    # conservation invariant stays a real, falsifiable property.
    unserved = sum(
        1
        for r in requests
        if r.finished is None and r.dropped is None
        and r.rejected is None and r.failed is None
    )
    lat = np.array(
        [r.finished - r.release for r in requests if r.finished is not None]
    )
    hook_ms = {h: s * 1e3 for h, s in zip(HOOKS, hook_s)}
    return SimResult(
        n_total=len(requests),
        n_finished_ok=ok,
        n_finished_late=late,
        n_dropped=dropped,
        n_unserved=unserved,
        worker_busy=worker_busy_time,
        makespan_ms=last_time,
        latencies=lat,
        n_workers=n,
        peak_heap_size=peak_heap,
        sched_time_ms=sum(hook_ms.values()),
        n_decisions=n_decisions,
        n_batches=n_batches,
        n_rejected=n_rejected,
        n_failed=n_failed,
        n_retried=n_retried,
        truncated=truncated,
        n_model_loads=res.n_loads if res is not None else 0,
        n_model_evicts=res.n_evicts if res is not None else 0,
        model_load_ms=res.load_ms_total if res is not None else 0.0,
        hook_ms=hook_ms,
        hook_calls=dict(zip(HOOKS, hook_n)),
        spans=spans,
    )


def _wheel_width(group_times: Sequence[float]) -> float | None:
    """Bucket width for the DONE/WAKE wheel: a few mean arrival-group gaps
    (batch completions land roughly once per served burst of arrivals), or
    ``None`` → pure-heapq mode when the trace gives no usable spread."""
    if len(group_times) < 2:
        return None
    span = group_times[-1] - group_times[0]
    if not (span > 0.0) or not math.isfinite(span):
        return None
    return 4.0 * span / (len(group_times) - 1)


def _array_loop(
    requests: Sequence[Request],
    workers: list[Worker],
    pool: _Pool,
    pick: _PickFn,
    *,
    horizon: float | None,
    charge_scheduler_overhead: bool,
    fs: "FaultStateLike | None" = None,
    res: "ResidencyStateLike | None" = None,
    wall_budget_s: float = 0.0,
) -> SimResult:
    """The array-backed engine behind ``run_event_loop(engine="array")``.

    Identical observable behaviour to the scalar loop — same scheduler-hook
    call sequence, same timestamps, same rng consumption, same result
    fields — with the event plumbing swapped out:

    - ARRIVALs never touch a priority queue: the
      :class:`~repro.core.requeststore.RequestStore` presorts the trace
      into numpy columns with same-timestamp group boundaries, so the
      arrival source is a cursor over precomputed slices (the scalar loop
      pays a heap push **and** pop per request);
    - DONE/WAKE events live in the :class:`~repro.core.eventwheel.EventWheel`
      calendar queue and are drained a bucket at a time; a three-way merge
      (arrival cursor, in-hand bucket batch, wheel head) preserves the
      scalar loop's global ``(time, seq)`` order, with arrivals numbered
      ``0..n-1`` before any dynamic event so same-timestamp arrivals still
      come first;
    - per-request state writes go to the store's ``started``/``finished``
      columns via one fancy-indexed write per *batch*, and the end-of-run
      stats fold is one vectorized pass (the object attributes are still
      written at event time — schedulers like Clipper read
      ``req.started``/``req.finished`` inside ``on_batch_done``).

    ``peak_heap_size`` reports peak *pending events*: undelivered arrivals
    plus wheel occupancy (in-flight DONEs, live and superseded WAKEs) —
    the satellite fix for the bucketed path, where "Python heap length"
    no longer exists.
    """
    n = len(workers)
    store = RequestStore(requests)
    reqs = store.requests
    gstarts = store.group_starts
    gtimes = store.group_times
    ng = len(gtimes)
    n_req = len(reqs)
    started_col = store.started
    finished_col = store.finished

    wheel = EventWheel(bucket_ms=_wheel_width(gtimes))
    # Arrivals conceptually hold seqs 0..n-1 (assigned at store build, in
    # release order); dynamic events keep counting — so at equal times
    # arrivals sort first, exactly like the scalar heap's (time, seq) keys.
    seq = itertools.count(n_req)

    plan = fs.plan if fs is not None else None
    n_rejected = 0
    n_failed = 0
    n_retried = 0
    n_finished = 0
    truncated = False
    down = [False] * n
    # per-worker crash epoch — see the scalar loop's tombstone comment
    epoch = [0] * n
    # in-flight (batch, rows) payloads, maintained only under a fault plan
    running: list[tuple[Batch, object] | None] = [None] * n
    gate = plan is not None and plan.admission_floor > 0.0
    timeout_ms = plan.batch_timeout_ms if plan is not None else 0.0
    if fs is not None and fs.crashes:
        # initial crash draws in worker index order — seqs continue from
        # n_req exactly like the scalar loop's post-arrival pushes
        for w in range(n):
            wheel.push(fs.next_crash(w, 0.0), next(seq), _CRASH, w)

    peak_pending = n_req + len(wheel)
    arr_left = n_req  # arrivals not yet delivered to a scheduler
    worker_busy_time = 0.0
    hook_s = [0.0] * len(HOOKS)  # wall-clock seconds inside each scheduler hook
    hook_n = [0] * len(HOOKS)
    n_decisions = 0
    n_batches = 0
    last_time = 0.0
    inflight: list[tuple[float, float] | None] = [None] * n  # (start, end)
    pending_wake: list[float | None] = [None] * n
    pc = _time.perf_counter
    delivers = [getattr(w.scheduler, "on_arrivals", None) for w in workers]
    # Columnar delivery hooks (DESIGN.md §10): a scheduler exposing
    # ``on_arrivals_cols(store, lo, hi, now)`` takes bulk arrivals as a
    # store row range instead of an object slice; ``on_arrival_row`` is
    # the idle-path single-row variant.  Schedulers without them get the
    # exact object-delivery sequence the scalar loop produces.
    delivers_cols = [
        getattr(w.scheduler, "on_arrivals_cols", None) for w in workers
    ]
    row_delivers = [
        getattr(w.scheduler, "on_arrival_row", None) for w in workers
    ]
    busy = pool.busy
    # Schedulers that read ``req.started``/``req.finished`` inside their
    # hooks (Clipper's AIMD, adaptive Clockwork) declare it via
    # ``reads_request_state``; unknown schedulers default to True for
    # safety.  When nobody in the pool reads mid-run state, the loop skips
    # the two per-request attribute writes on the hot path and flushes the
    # columns once at the end (``store.writeback()``) instead.
    live_state = any(
        getattr(w.scheduler, "reads_request_state", True) for w in workers
    )

    def try_dispatch(w: int, now: float) -> None:
        nonlocal worker_busy_time, peak_pending, n_decisions
        if busy[w] or down[w]:
            return
        worker = workers[w]
        # simlint: ignore[R1] -- meters real scheduler overhead (reported, optionally charged as latency); the sim clock itself stays virtual
        t0 = pc()
        batch, wake = worker.scheduler.next_batch(now)
        # simlint: ignore[R1] -- closes the overhead meter opened above
        dt = pc() - t0
        hook_s[_NEXT_BATCH] += dt
        hook_n[_NEXT_BATCH] += 1
        n_decisions += 1
        overhead = dt * 1e3 if charge_scheduler_overhead else 0.0
        if batch is not None and getattr(batch, "decode", False):
            # Resumable token-level execution — the array flavour of the
            # scalar loop's decode dispatch: identical hook order and
            # timestamps, with per-batch column writes for ``started``.
            if fs is not None:
                raise ValueError(
                    "decode (token-level) batches are not supported "
                    "under fault injection"
                )
            if res is not None:
                raise ValueError(
                    "decode (token-level) batches are not supported "
                    "under multi-model residency"
                )
            start = now + overhead
            rows = batch.rows
            if rows is None:
                # simlint: ignore[R5] -- one row-index list per dispatched decode batch
                rows = store.rows_for(batch.requests)
            if type(rows) is range and rows.step == 1:
                started_col[rows.start:rows.stop] = start
            else:
                rows = np.asarray(rows, dtype=np.intp)
                started_col[rows] = start
            run = _DecodeRun(
                batch, list(batch.requests), [int(x) for x in rows]
            )
            dur = _decode_step_dur(
                worker.executor, run.active, batch.requests, start
            )
            if pool.track_work:
                if live_state:
                    for r in batch.requests:
                        r.started = start
                        pool.discharge(w, r.rid)
                else:
                    for r in batch.requests:
                        pool.discharge(w, r.rid)
            elif live_state:
                for r in batch.requests:
                    r.started = start
            busy[w] = True
            worker_busy_time += dur
            inflight[w] = (start, start + dur)
            wheel.push(start + dur, next(seq), _STEP, (w, run, epoch[w]))
            pending = arr_left + len(wheel)
            if pending > peak_pending:
                peak_pending = pending
        elif batch is not None:
            start = now + overhead
            if res is not None:
                # Weights residency — charged exactly as in the scalar
                # loop: same acquire() call order, same stall arithmetic.
                if batch.model is None:
                    raise ValueError(
                        "residency-managed run dispatched a batch without "
                        "a model id (scheduler must stamp Batch.model)"
                    )
                stall = res.acquire(w, batch.model, start)
                start += stall
            else:
                stall = 0.0
            dur = worker.executor(batch, start)
            ev_kind = _DONE
            if fs is not None:
                dur = fs.straggle(dur)
                if 0.0 < timeout_ms < dur:
                    # overlong batch: aborted at the timeout deadline
                    dur = timeout_ms
                    ev_kind = _ABORT
            rows = batch.rows
            if rows is None:
                # simlint: ignore[R5] -- one row-index list per dispatched batch: the price of one fancy-indexed column write replacing per-request attribute churn
                rows = store.rows_for(batch.requests)
            if type(rows) is range and rows.step == 1:
                # rows-annotated batch (``on_arrivals_cols`` schedulers):
                # the column write is an O(1) slice assignment
                started_col[rows.start:rows.stop] = start
            else:
                rows = np.asarray(rows, dtype=np.intp)
                started_col[rows] = start
            if pool.track_work:
                if live_state:
                    for r in batch.requests:
                        r.started = start
                        pool.discharge(w, r.rid)
                else:
                    for r in batch.requests:
                        pool.discharge(w, r.rid)
            elif live_state:
                for r in batch.requests:
                    r.started = start
            busy[w] = True
            worker_busy_time += stall + dur
            inflight[w] = (start - stall, start + dur)
            if fs is not None:
                running[w] = (batch, rows)
            wheel.push(
                start + dur, next(seq), ev_kind, (w, batch, rows, epoch[w])
            )
            pending = arr_left + len(wheel)
            if pending > peak_pending:
                peak_pending = pending
        elif wake is not None and np.isfinite(wake) and wake > now:
            if pending_wake[w] is None or wake < pending_wake[w]:
                pending_wake[w] = wake
                wheel.push(wake, next(seq), _WAKE, w)
                pending = arr_left + len(wheel)
                if pending > peak_pending:
                    peak_pending = pending
        # the decision may have timed requests out (drop phase) — keep the
        # policy load signal honest
        pool.sweep_dropped(w)

    def work_remains() -> bool:
        # see the scalar loop: crashes only reschedule while unresolved
        # work exists anywhere, so the wheel can drain
        resolved = n_finished + n_rejected + n_failed
        for w_ in workers:
            resolved += w_.scheduler.n_timed_out  # type: ignore[attr-defined]
        return resolved < n_req

    def abort_batch(w: int, batch: Batch, rows, now: float) -> None:
        # Crash/timeout abort, array flavour: clear the started column
        # for the aborted rows (writeback must not resurrect a phantom
        # start), then run each request through the retry gate.
        nonlocal n_failed, n_retried, peak_pending
        assert fs is not None
        if type(rows) is range:
            started_col[rows.start:rows.stop] = np.nan
        else:
            started_col[np.asarray(rows, dtype=np.intp)] = np.nan
        sched = workers[w].scheduler
        for r in batch.requests:
            if live_state:
                r.started = None
            retry, t_retry = fs.retry_decision(sched, r, now)
            if retry:
                r.retries += 1
                n_retried += 1
                wheel.push(t_retry, next(seq), _RETRY, r)
            else:
                r.failed = now
                n_failed += 1
        pending = arr_left + len(wheel)
        if pending > peak_pending:
            peak_pending = pending

    wall_deadline = None
    if wall_budget_s > 0.0:
        # simlint: ignore[R1] -- wall-budget truncation is real elapsed time by design; the sim clock stays virtual
        wall_deadline = pc() + wall_budget_s
    n_events = 0
    gi = 0  # next arrival group
    buf: list = []  # in-hand wheel bucket (drained, partially consumed)
    bi = 0
    nbuf = 0
    ev: tuple = ()
    while True:
        n_events += 1
        if (
            wall_deadline is not None
            and not n_events & 1023
            # simlint: ignore[R1] -- wall-budget truncation check (real elapsed time by design)
            and pc() > wall_deadline
        ):
            # Out of wall-clock budget: stop at the last processed event
            # and clamp busy credit, mirroring the scalar loop.
            truncated = True
            for span in inflight:
                if span is not None and span[1] > last_time:
                    worker_busy_time -= span[1] - max(span[0], last_time)
            break
        # --- three-way merge: arrival cursor vs in-hand bucket vs wheel ---
        t_arr = gtimes[gi] if gi < ng else math.inf
        if bi < nbuf:
            ev = buf[bi]
            ekey = (ev[0], ev[1])
            take = _TAKE_BUF
            if wheel:
                wkey = wheel.peek_key()
                if wkey < ekey:
                    # an event pushed *during* the current bucket batch
                    # landed before its remaining entries — take it singly
                    ekey = wkey
                    take = _TAKE_ONE
        elif wheel:
            ekey = wheel.peek_key()
            take = _TAKE_BUCKET
        else:
            ekey = _NO_EVENT
            take = 0
        if t_arr <= ekey[0]:
            if t_arr == math.inf:
                break  # arrivals, bucket batch and wheel all exhausted
            now = t_arr
            if horizon is not None and now > horizon:
                last_time = horizon
                for span in inflight:
                    if span is not None and span[1] > horizon:
                        worker_busy_time -= span[1] - max(span[0], horizon)
                break
            last_time = now
            a, b = gstarts[gi], gstarts[gi + 1]
            gi += 1
            arr_left -= b - a
            if n == 1:
                # Single-worker fast path (the benchmark regime): no picks,
                # no charges.  While the worker is idle its share of the
                # burst is delivered one request at a time with a dispatch
                # attempt in between (scalar semantics: an urgent
                # head-of-burst request can grab the idle worker); the
                # moment it goes busy the rest of the group is ONE slice
                # handed to bulk ``on_arrivals`` — no per-request Python at
                # all, which is where the array engine's throughput lives.
                sched0 = workers[0].scheduler
                dr0 = row_delivers[0]
                if gate:
                    # Admission-gated single-worker path: per-request
                    # probes mirror the scalar loop exactly (idle-phase
                    # delivery with dispatch attempts, then one bulk
                    # object flush for the admitted busy-phase tail).
                    # Kept entirely off the fault-free fast path below.
                    assert fs is not None
                    # simlint: ignore[R5] -- one admitted-tail buffer per gated burst
                    held: list[Request] = []
                    for i in range(a, b):
                        req = reqs[i]
                        if not fs.admit(
                            sched0,
                            req,
                            now,
                            # mirrors the scalar backlog probe: len(held)
                            # plays pending_offset's role (this path never
                            # charges the pool)
                            getattr(sched0, "n_pending", 0)
                            + len(held)
                            + (1 if busy[0] else 0),
                        ):
                            req.rejected = now
                            n_rejected += 1
                            continue
                        if busy[0]:
                            held.append(req)
                            continue
                        t0 = pc()  # simlint: ignore[R1] -- overhead meter, not sim time
                        if dr0 is not None:
                            dr0(store, i, now)
                        else:
                            sched0.on_arrival(req, now)
                        hook_s[_ON_ARRIVAL] += pc() - t0  # simlint: ignore[R1] -- overhead meter, not sim time
                        hook_n[_ON_ARRIVAL] += 1
                        try_dispatch(0, now)
                    if held:
                        deliver = delivers[0]
                        t0 = pc()  # simlint: ignore[R1] -- overhead meter, not sim time
                        if deliver is not None:
                            deliver(held, now)
                        else:
                            for req in held:
                                sched0.on_arrival(req, now)
                        hook_s[_ON_ARRIVAL] += pc() - t0  # simlint: ignore[R1] -- overhead meter, not sim time
                        hook_n[_ON_ARRIVAL] += len(held)
                    continue
                i = a
                while i < b and not busy[0]:
                    t0 = pc()  # simlint: ignore[R1] -- overhead meter, not sim time
                    if dr0 is not None:
                        dr0(store, i, now)
                    else:
                        sched0.on_arrival(reqs[i], now)
                    hook_s[_ON_ARRIVAL] += pc() - t0  # simlint: ignore[R1] -- overhead meter, not sim time
                    hook_n[_ON_ARRIVAL] += 1
                    i += 1
                    try_dispatch(0, now)
                if i < b:
                    dc0 = delivers_cols[0]
                    deliver = delivers[0]
                    t0 = pc()  # simlint: ignore[R1] -- overhead meter, not sim time
                    if dc0 is not None:
                        # columnar bulk delivery: a row range, no slice
                        dc0(store, i, b, now)
                    elif deliver is not None:
                        # simlint: ignore[R5] -- one slice per (burst, busy) window, replacing per-request heap pops and scheduler calls
                        deliver(reqs[i:b], now)
                    else:
                        for req in reqs[i:b]:
                            sched0.on_arrival(req, now)
                    hook_s[_ON_ARRIVAL] += pc() - t0  # simlint: ignore[R1] -- overhead meter, not sim time
                    hook_n[_ON_ARRIVAL] += b - i
            else:
                # Multi-worker: route/deliver in arrival order, exactly as
                # the scalar loop does (same pick → same rng draws, same
                # charge/busy side-effect ordering, same bulk flush per
                # busy worker).
                # simlint: ignore[R5] -- one routing buffer per burst, replacing per-request scheduler calls with one bulk delivery per worker
                buffered: dict[int, list[Request]] = {}
                for i in range(a, b):
                    req = reqs[i]
                    w = pick(req, now, pool)
                    if gate and not fs.admit(
                        workers[w].scheduler,
                        req,
                        now,
                        getattr(workers[w].scheduler, "n_pending", 0)
                        + pool.pending_offset[w]
                        + (1 if busy[w] else 0),
                    ):
                        # shed at the front door (pick already consumed
                        # its rng draws — same stream with the gate off)
                        req.rejected = now
                        n_rejected += 1
                        continue
                    pool.charge(w, req)
                    if busy[w]:
                        # simlint: ignore[R5] -- group list created once per (burst, worker), not per request
                        buffered.setdefault(w, []).append(req)
                        pool.pending_offset[w] += 1
                    else:
                        t0 = pc()  # simlint: ignore[R1] -- overhead meter, not sim time
                        workers[w].scheduler.on_arrival(req, now)
                        hook_s[_ON_ARRIVAL] += pc() - t0  # simlint: ignore[R1] -- overhead meter, not sim time
                        hook_n[_ON_ARRIVAL] += 1
                        try_dispatch(w, now)
                for w, group in buffered.items():
                    pool.pending_offset[w] = 0
                    deliver = delivers[w]
                    t0 = pc()  # simlint: ignore[R1] -- overhead meter, not sim time
                    if deliver is not None:
                        deliver(group, now)
                    else:
                        sched = workers[w].scheduler
                        for req in group:
                            sched.on_arrival(req, now)
                    hook_s[_ON_ARRIVAL] += pc() - t0  # simlint: ignore[R1] -- overhead meter, not sim time
                    hook_n[_ON_ARRIVAL] += len(group)
            continue
        # --- dynamic event (DONE/WAKE) ---
        if take == _TAKE_BUF:
            now, _s, kind, payload = ev
            bi += 1
        elif take == _TAKE_BUCKET:
            # refill the in-hand batch with the next wheel bucket — the
            # batched DONE/WAKE path: one calendar-bucket drain amortizes
            # the queue maintenance over every event in the bucket
            buf = wheel.pop_bucket()
            bi = 1
            nbuf = len(buf)
            now, _s, kind, payload = buf[0]
        else:  # _TAKE_ONE
            now, _s, kind, payload = wheel.pop()
        if horizon is not None and now > horizon:
            last_time = horizon
            for span in inflight:
                if span is not None and span[1] > horizon:
                    worker_busy_time -= span[1] - max(span[0], horizon)
            break
        last_time = now
        if kind == _DONE:
            w, batch, rows, ep = payload
            if ep != epoch[w]:
                continue  # tombstone: the worker crashed under this batch
            busy[w] = False
            inflight[w] = None
            if fs is not None:
                running[w] = None
            n_batches += 1
            n_finished += len(batch.requests)
            if type(rows) is range:
                finished_col[rows.start:rows.stop] = now
                alone = store.true_time[rows.start:rows.stop].tolist()
            else:
                finished_col[rows] = now
                # simlint: ignore[R5] -- one alone-times list per completed batch (feedback path), not per request
                alone = store.true_time[rows].tolist()
            if live_state:
                for r in batch.requests:
                    r.finished = now
            t0 = pc()  # simlint: ignore[R1] -- overhead meter, not sim time
            workers[w].scheduler.on_batch_done(batch, now, alone)
            hook_s[_ON_BATCH_DONE] += pc() - t0  # simlint: ignore[R1] -- overhead meter, not sim time
            hook_n[_ON_BATCH_DONE] += 1
            try_dispatch(w, now)
        elif kind == _STEP:
            # One decode iteration — mirrors the scalar loop's handler
            # exactly (same hook order, same timestamps), with ``finished``
            # landing in the store column per step instead of per object.
            w, run, ep = payload
            if ep != epoch[w]:
                continue  # tombstone (kept uniform with _DONE)
            finished, fin_rows = _advance_decode(run, now)
            n_finished += len(finished)
            if fin_rows:
                finished_col[np.asarray(fin_rows, dtype=np.intp)] = now
            if live_state:
                for r in finished:
                    r.finished = now
            t0 = pc()  # simlint: ignore[R1] -- overhead meter, not sim time
            joined = workers[w].scheduler.on_decode_step(
                finished, len(run.active), now
            )
            hook_s[_ON_DECODE_STEP] += pc() - t0  # simlint: ignore[R1] -- overhead meter, not sim time
            hook_n[_ON_DECODE_STEP] += 1
            n_decisions += 1
            if joined:
                # simlint: ignore[R5] -- one row-index list per join group
                jrows = store.rows_for(joined)
                started_col[np.asarray(jrows, dtype=np.intp)] = now
                run.rows.extend(int(x) for x in jrows)
                if pool.track_work:
                    if live_state:
                        for r in joined:
                            r.started = now
                            pool.discharge(w, r.rid)
                    else:
                        for r in joined:
                            pool.discharge(w, r.rid)
                elif live_state:
                    for r in joined:
                        r.started = now
                run.active.extend(joined)
            if run.active:
                dur = _decode_step_dur(
                    workers[w].executor, run.active, joined, now
                )
                worker_busy_time += dur
                inflight[w] = (now, now + dur)
                wheel.push(now + dur, next(seq), _STEP, (w, run, ep))
                pending = arr_left + len(wheel)
                if pending > peak_pending:
                    peak_pending = pending
            else:
                n_batches += 1
                busy[w] = False
                inflight[w] = None
                try_dispatch(w, now)
            # the admission hook may also have timed requests out
            pool.sweep_dropped(w)
        elif kind == _WAKE:
            w = payload
            if pending_wake[w] is not None and now >= pending_wake[w]:
                pending_wake[w] = None
            try_dispatch(w, now)
        elif kind == _ABORT:
            w, batch, rows, ep = payload
            if ep != epoch[w]:
                continue  # the worker crashed before the timeout fired
            busy[w] = False
            inflight[w] = None
            running[w] = None
            abort_batch(w, batch, rows, now)
            try_dispatch(w, now)
        elif kind == _CRASH:
            w = payload
            if work_remains():
                # see the scalar loop: epoch bump tombstones the pending
                # DONE/ABORT, the in-flight batch aborts, restart follows
                epoch[w] += 1
                down[w] = True
                span = inflight[w]
                if span is not None:
                    worker_busy_time -= span[1] - max(span[0], now)
                    inflight[w] = None
                    busy[w] = False
                    doomed = running[w]
                    running[w] = None
                    assert doomed is not None
                    abort_batch(w, doomed[0], doomed[1], now)
                wheel.push(
                    now + plan.restart_delay_ms, next(seq), _RESTART, w
                )
                pending = arr_left + len(wheel)
                if pending > peak_pending:
                    peak_pending = pending
        elif kind == _RESTART:
            w = payload
            down[w] = False
            if work_remains():
                wheel.push(fs.next_crash(w, now), next(seq), _CRASH, w)
                pending = arr_left + len(wheel)
                if pending > peak_pending:
                    peak_pending = pending
            try_dispatch(w, now)
        else:  # _RETRY
            req = payload
            w = pick(req, now, pool) if n > 1 else 0
            if down[w]:
                # dead-target re-route — see the scalar loop
                for k in range(1, n):
                    w2 = (w + k) % n
                    if not down[w2]:
                        w = w2
                        break
            pool.charge(w, req)
            t0 = pc()  # simlint: ignore[R1] -- overhead meter, not sim time
            workers[w].scheduler.on_arrival(req, now)
            hook_s[_ON_ARRIVAL] += pc() - t0  # simlint: ignore[R1] -- overhead meter, not sim time
            hook_n[_ON_ARRIVAL] += 1
            try_dispatch(w, now)

    if not live_state:
        # Mid-run object writes were skipped — flush the state columns
        # onto the Request objects so callers see the scalar loop's exact
        # post-run per-object state.
        store.writeback()
    # Drop-free fast path: every ``req.dropped = ...`` write in the repo's
    # schedulers is paired with an ``n_timed_out`` increment, so a pool
    # whose schedulers all expose the counter at zero provably dropped
    # nothing and the O(n) per-object dropped scan can be skipped.
    no_drops = all(
        getattr(w_.scheduler, "n_timed_out", None) == 0 for w_ in workers
    )
    ok, late, dropped, unserved, lat = store.fold_stats(
        no_drops=no_drops, n_off_ledger=n_rejected + n_failed
    )
    hook_ms = {h: s * 1e3 for h, s in zip(HOOKS, hook_s)}
    return SimResult(
        n_total=n_req,
        n_finished_ok=ok,
        n_finished_late=late,
        n_dropped=dropped,
        n_unserved=unserved,
        worker_busy=worker_busy_time,
        makespan_ms=last_time,
        latencies=lat,
        n_workers=n,
        peak_heap_size=peak_pending,
        sched_time_ms=sum(hook_ms.values()),
        n_decisions=n_decisions,
        n_batches=n_batches,
        n_rejected=n_rejected,
        n_failed=n_failed,
        n_retried=n_retried,
        truncated=truncated,
        n_model_loads=res.n_loads if res is not None else 0,
        n_model_evicts=res.n_evicts if res is not None else 0,
        model_load_ms=res.load_ms_total if res is not None else 0.0,
        hook_ms=hook_ms,
        hook_calls=dict(zip(HOOKS, hook_n)),
    )


def simulate(
    requests: Sequence[Request],
    scheduler: SchedulerLike,
    executor: Executor,
    horizon: float | None = None,
    charge_scheduler_overhead: bool = False,
    engine: str = "scalar",
    faults: "FaultPlanLike | None" = None,
    wall_budget_s: float = 0.0,
) -> SimResult:
    """The single-worker evaluation harness (§5) — the 1-worker case of
    :func:`run_event_loop`, kept as the stable entry point."""
    return run_event_loop(
        requests,
        [Worker(scheduler, executor)],
        policy="round_robin",
        horizon=horizon,
        charge_scheduler_overhead=charge_scheduler_overhead,
        engine=engine,
        faults=faults,
        wall_budget_s=wall_budget_s,
    )
