"""Requests, applications and SLO cost functions (paper §3.1, §4.1, App. B).

A request is defined by its *release time* and *deadline* (release + SLO) and
has a hidden minimum *execution time* (time to execute alone).  The SLO cost
function is a step: finishing after the deadline incurs penalty ``c``
(Fig. 5).  Appendix B generalises to piecewise-step functions, which
decompose into a sum of single steps — we implement that decomposition.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

__all__ = ["StepCost", "PiecewiseStepCost", "Request"]

_req_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Single-step SLO cost: 0 before ``deadline``, ``cost`` after (Fig. 5)."""

    deadline: float
    cost: float = 1.0

    def __call__(self, t: float) -> float:
        return self.cost if t > self.deadline else 0.0

    def steps(self) -> list["StepCost"]:
        return [self]


@dataclasses.dataclass(frozen=True)
class PiecewiseStepCost:
    """Multi-step SLO cost function (Appendix B).

    ``deadlines`` d1 < d2 < ... with cumulative costs c1 < c2 < ...
    Decomposes into single steps with incremental costs
    (d1, c1), (d2, c2 - c1), ...; priority scores are computed per step and
    summed.
    """

    deadlines: tuple[float, ...]
    costs: tuple[float, ...]

    def __post_init__(self) -> None:
        if len(self.deadlines) != len(self.costs) or not self.deadlines:
            raise ValueError("deadlines and costs must be equal-length, non-empty")
        if any(b <= a for a, b in zip(self.deadlines, self.deadlines[1:])):
            raise ValueError("deadlines must be strictly increasing")
        if any(b <= a for a, b in zip(self.costs, self.costs[1:])):
            raise ValueError("costs must be strictly increasing")

    def __call__(self, t: float) -> float:
        total = 0.0
        for d, c in zip(self.deadlines, self.costs):
            if t > d:
                total = c
        return total

    def steps(self) -> list[StepCost]:
        out = []
        prev = 0.0
        for d, c in zip(self.deadlines, self.costs):
            out.append(StepCost(d, c - prev))
            prev = c
        return out


@dataclasses.dataclass(slots=True)
class Request:
    """An inference request.

    ``true_time`` is the ground-truth standalone execution time.  It is
    *hidden* from every scheduler (partial-information constraint, §3.1);
    only the simulator/executor reads it.  Schedulers see only ``app_id``,
    ``release``, ``deadline`` and the learned per-app distribution.

    Slotted: a 10⁵–10⁶-request trace materializes one object per request
    even under the array engine (they remain the scheduler-facing
    currency), so per-instance dicts would dominate trace memory — and the
    simulator's bookkeeping writes (``started``/``finished``/``dropped``)
    are measurably faster through slot descriptors.
    """

    app_id: str
    release: float
    slo: float
    true_time: float
    rid: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    cost: float = 1.0
    extra_deadlines: tuple[tuple[float, float], ...] = ()
    payload: Any = None  # e.g. token ids for the real JAX engine
    # Multi-model serving (DESIGN.md §13): which zoo model this request
    # targets.  ``None`` (every single-model trace) keeps the residency
    # tier fully inert.  Visible to schedulers and dispatch policies —
    # clients know what model they are calling.
    model_id: str | None = None

    # Token-level (continuous batching) fields.  ``prompt_tokens`` is
    # visible to schedulers (the prompt is known at admission);
    # ``out_tokens`` is the hidden ground-truth output length — the
    # data-dependent quantity nobody knows until EOS, the token-mode
    # analogue of ``true_time`` (§3.1 partial-information constraint).
    # In token mode ``slo``/``deadline`` are *derived from* ``out_tokens``
    # (slo = TTFT + TPOT·(out_tokens−1)), so they are hidden from token
    # schedulers by the same convention (DESIGN.md §12).
    prompt_tokens: int = 0
    out_tokens: int = 0

    # Bookkeeping filled in by the simulator / engine.  Exactly one of
    # ``finished``/``dropped``/``rejected``/``failed`` is set at end of
    # run (or none: unserved) — the conservation invariant the fault
    # tier property-tests.
    started: float | None = None
    finished: float | None = None
    dropped: float | None = None
    # Fault-tier terminal states: rejected at admission (never queued),
    # or failed after a crash/timeout abort exhausted the retry gate.
    rejected: float | None = None
    failed: float | None = None
    retries: int = 0
    # Token-mode bookkeeping, written by the decode-step machinery:
    # ``tokens_done`` advances once per decode iteration; ``first_token``
    # is the virtual time the first output token completed (TTFT anchor).
    tokens_done: int = 0
    first_token: float | None = None

    @property
    def deadline(self) -> float:
        return self.release + self.slo

    def cost_fn(self) -> StepCost | PiecewiseStepCost:
        if not self.extra_deadlines:
            return StepCost(self.deadline, self.cost)
        ds = (self.deadline,) + tuple(self.release + d for d, _ in self.extra_deadlines)
        cs = (self.cost,) + tuple(c for _, c in self.extra_deadlines)
        return PiecewiseStepCost(ds, cs)

    @property
    def ok(self) -> bool:
        return self.finished is not None and self.finished <= self.deadline

    def __hash__(self) -> int:
        return self.rid

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Request) and other.rid == self.rid
