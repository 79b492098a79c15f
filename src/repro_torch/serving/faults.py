"""Seeded, deterministic fault injection for the event engines (the
robustness tier: ISSUE 8, DESIGN.md §11).

Every cell of the eval grid used to assume a fault-free fleet.  This
module defines the failure model the engines replay:

- **worker crashes** — per-worker renewal process with exponential MTTF
  (``mttf_ms``) and a fixed ``restart_delay_ms``.  A crash aborts the
  in-flight batch; its requests re-enter the scheduler queue through the
  deadline-aware retry gate below.
- **stragglers** — a sampled fraction (``straggler_prob``) of batch
  executions is slowed by ``straggler_factor`` (the data-dependent tail
  the paper's premise is about, § "unpredictable DNNs").
- **admission control** — when ``admission_floor > 0``, an arrival whose
  Eq.-2-style finish probability is already below the floor is rejected
  at the front door (``request.rejected``) instead of thrashing the
  queue.
- **batch timeout** — when ``batch_timeout_ms > 0``, a batch whose
  sampled duration exceeds the timeout is aborted at the deadline and
  its requests go through the same retry gate (the real
  :class:`~repro.serving.engine.ServingEngine` abort path).

Retry gate (deadline-aware backoff): an aborted request with retry
budget left is re-queued at ``now + retry_backoff_ms * 2**retries``
(capped so the retry never lands past the last feasible start), but
only if its finish probability at that instant still clears
``retry_threshold`` — otherwise it is dropped *honestly* as ``failed``
rather than queued to die.

Determinism: the plan owns its own PRNG streams, spawned from
``SeedSequence(seed)`` **independently of the trace and policy rngs** —
child ``w`` drives worker ``w``'s crash renewals and the last child
drives straggler sampling.  Per-worker crash streams plus
dispatch-ordered straggler draws make the draw sequence identical in
the scalar and array engines, which is what lets the bit-identity
equivalence claim extend to every ``FaultPlan``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Mapping

import numpy as np

from ..core.eventloop import _expected_alone

if TYPE_CHECKING:  # pragma: no cover - typing-only imports
    from ..core.eventloop import SchedulerLike
    from ..core.request import Request

__all__ = ["FaultPlan", "FaultState", "finish_probability"]


def finish_probability(
    scheduler: "SchedulerLike", req: "Request", now: float
) -> float:
    """Eq.-2-style probability that ``req`` can still finish by its
    deadline if its (bs=1) execution started at ``now``.

    Uses the scheduler's learned per-app alone-time distribution when it
    has one (``P[c0 + c1·l_alone <= slack]`` under the empirical CDF),
    degrades to a deterministic 0/1 test against the scalar point
    estimator for baselines, and returns 1.0 for schedulers with no
    latency knowledge at all (benchmark FIFOs) — an optimistic gate is a
    no-op gate, which is the honest default.
    """
    slack = req.deadline - now
    if slack <= 0.0:
        return 0.0
    lm = getattr(scheduler, "latency_model", None)
    c0 = float(lm.c0) if lm is not None else 0.0
    c1 = float(lm.c1) if lm is not None else 1.0
    dists = getattr(scheduler, "_app_dists", None)
    if dists and req.app_id in dists:
        if c1 <= 0.0:
            return 1.0 if c0 <= slack else 0.0
        return float(dists[req.app_id].cdf((slack - c0) / c1))
    est = getattr(scheduler, "est", None)
    if est is not None:
        return 1.0 if c0 + c1 * float(est.value()) <= slack else 0.0
    return 1.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, seeded failure model (all knobs off by default).

    A plan with every knob at its default is *disabled*: the engines
    still thread it through the hook points (the ``fault-free-noop``
    claim exercises exactly this), but no rng is consumed and no fault
    event is ever scheduled, so results are bitwise identical to running
    with no plan at all.
    """

    seed: int = 0
    # worker crashes: exponential MTTF renewal process, off when 0
    mttf_ms: float = 0.0
    restart_delay_ms: float = 0.0
    # retry gate for crash/timeout-aborted requests
    max_retries: int = 2
    retry_backoff_ms: float = 0.0
    retry_threshold: float = 0.0
    # stragglers: multiplicative slowdown on a sampled execution fraction
    straggler_prob: float = 0.0
    straggler_factor: float = 1.0
    # admission control: reject at arrival below this finish probability
    admission_floor: float = 0.0
    # abort batches running longer than this (ServingEngine abort path)
    batch_timeout_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.mttf_ms < 0 or self.restart_delay_ms < 0:
            raise ValueError("mttf_ms/restart_delay_ms must be >= 0")
        if self.max_retries < 0 or self.retry_backoff_ms < 0:
            raise ValueError("max_retries/retry_backoff_ms must be >= 0")
        if not 0.0 <= self.straggler_prob <= 1.0:
            raise ValueError("straggler_prob must be in [0, 1]")
        if self.straggler_prob > 0 and self.straggler_factor < 1.0:
            raise ValueError("straggler_factor must be >= 1")
        if not 0.0 <= self.admission_floor <= 1.0:
            raise ValueError("admission_floor must be in [0, 1]")
        if self.batch_timeout_ms < 0:
            raise ValueError("batch_timeout_ms must be >= 0")

    def enabled(self) -> bool:
        """True when any fault mechanism can actually fire."""
        return (
            self.mttf_ms > 0.0
            or self.straggler_prob > 0.0
            or self.admission_floor > 0.0
            or self.batch_timeout_ms > 0.0
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "FaultPlan":
        """Build from a spec-level dict, ignoring unknown keys (so old
        eval artifacts stay parseable as the plan grows knobs)."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def start(self, n_workers: int) -> "FaultState":
        """Materialize per-run mutable state (rng streams) for a pool."""
        return FaultState(self, n_workers)


class FaultState:
    """Per-run fault machinery: the plan plus its live PRNG streams.

    One :class:`numpy.random.Generator` per worker for crash renewals
    (children ``0..n-1`` of the plan's seed sequence) and one shared
    stream for straggler sampling (child ``n``).  Per-worker crash
    streams mean the *set* of draws depends only on how long each worker
    stays up — not on the interleaving of other events — so the scalar
    and array engines consume identical randomness.
    """

    __slots__ = ("plan", "crashes", "_crash_rngs", "_straggler_rng")

    def __init__(self, plan: FaultPlan, n_workers: int):
        self.plan = plan
        self.crashes = plan.mttf_ms > 0.0
        children = np.random.SeedSequence(plan.seed).spawn(n_workers + 1)
        self._crash_rngs = [
            np.random.default_rng(children[w]) for w in range(n_workers)
        ]
        self._straggler_rng = np.random.default_rng(children[n_workers])

    def next_crash(self, w: int, up_since: float) -> float:
        """Absolute (virtual ms) time of worker ``w``'s next crash given
        it came up at ``up_since``.  Consumes one exponential draw from
        the worker's own stream."""
        return up_since + float(
            self._crash_rngs[w].exponential(self.plan.mttf_ms)
        )

    def straggle(self, dur: float) -> float:
        """Apply the straggler model to a sampled batch duration.
        Consumes one uniform draw per dispatched batch iff the straggler
        knob is on (draws happen in dispatch order — engine-invariant)."""
        p = self.plan
        if p.straggler_prob <= 0.0:
            return dur
        if float(self._straggler_rng.random()) < p.straggler_prob:
            return dur * p.straggler_factor
        return dur

    def admit(
        self,
        scheduler: "SchedulerLike",
        req: "Request",
        now: float,
        queued_ahead: int = 0,
    ) -> bool:
        """Admission gate: accept iff the estimated finish probability
        clears the plan's floor.  Eq.-2 conditions on *when the request
        can start*, not on its arrival instant (at arrival the slack is
        always the full SLO window), so the probability is evaluated at
        ``now`` pushed out by the expected service of the
        ``queued_ahead`` requests already on the picked worker (queue +
        in-flight batch), each costed at the scheduler's own bs=1
        estimate for this request's app.  Consumes no rng."""
        t_start = now
        if queued_ahead > 0:
            lm = getattr(scheduler, "latency_model", None)
            c0 = float(lm.c0) if lm is not None else 0.0
            c1 = float(lm.c1) if lm is not None else 1.0
            t_start = now + queued_ahead * (
                c0 + c1 * _expected_alone(scheduler, req)
            )
        return (
            finish_probability(scheduler, req, t_start)
            >= self.plan.admission_floor
        )

    def retry_decision(
        self, scheduler: "SchedulerLike", req: "Request", now: float
    ) -> tuple[bool, float]:
        """Deadline-aware retry gate for an aborted request.

        Returns ``(retry, t_retry)``.  The retry lands after exponential
        backoff (``retry_backoff_ms * 2**retries``), capped so it never
        backs off past the last start that could still make the deadline
        under the scheduler's own bs=1 estimate.  Retry only when budget
        remains *and* the finish probability at ``t_retry`` clears the
        threshold (with a hard floor of "the deadline has not already
        passed") — otherwise the caller records the request as
        ``failed``.  Deterministic: consumes no rng.
        """
        p = self.plan
        if req.retries >= p.max_retries:
            return False, now
        t_retry = now + p.retry_backoff_ms * (2.0 ** req.retries)
        lm = getattr(scheduler, "latency_model", None)
        c0 = float(lm.c0) if lm is not None else 0.0
        c1 = float(lm.c1) if lm is not None else 1.0
        # latest feasible start under the scheduler's own alone estimate
        latest = req.deadline - (c0 + c1 * _expected_alone(scheduler, req))
        if t_retry > latest:
            t_retry = max(now, latest)
        prob = finish_probability(scheduler, req, t_retry)
        if prob <= 0.0 or prob < p.retry_threshold:
            return False, now
        return True, t_retry
