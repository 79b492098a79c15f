"""A run's span log: where the host's time goes inside the event loop, the
executor and the engine's set-up, on the device trace's clock.

A :class:`SpanLog` is off unless a caller makes one and passes it:
``run_event_loop(..., spans=log)`` records each scheduler hook and each
dispatch, ``TorchExecutor.spans = log`` each served batch's host part and
replay, and ``TorchServingEngine.profile_latency_model`` the fit.  Spans
are stamped with :func:`time.time_ns`, the host's wall clock in
nanoseconds, which is also the clock in which ``torch.profiler`` (Kineto)
stamps the device's kernels, so a span can be laid directly over a device
trace.  The log keeps its intervals in memory, in a preallocated ring of
``capacity`` entries (the oldest are overwritten once it is full; the
per-name totals are always whole), and writes nothing out.

Names are the module's constants (:data:`NAMES`); any other name raises.
"""

from __future__ import annotations

import time as _time
from typing import Iterable, Sequence

import numpy as np

from .request import Request

# The scalar event loop: each scheduler hook, the loop itself.
SCHED_NEXT_BATCH = "sched.next_batch"  # arg: the dispatched batch's size (0: none)
SCHED_ON_ARRIVAL = "sched.on_arrival"  # one span per call, also a bulk one
SCHED_ON_BATCH_DONE = "sched.on_batch_done"
SCHED_ON_DECODE_STEP = "sched.on_decode_step"
LOOP_RUN = "loop.run"  # from the first event to the last one processed
# The serving executor (``serving.engine.TorchExecutor``): a served batch's
# padding, its tokens' copy to the device up to the pre-replay synchronize,
# the replay up to the closing synchronize (the bracket of its measured
# time), and a shape's first use (warm-up and graph capture).
EXEC_PAD = "exec.pad"
EXEC_H2D = "exec.h2d"
EXEC_REPLAY = "exec.replay"
EXEC_CAPTURE = "exec.capture"
# The Eq.-3 fit (``TorchServingEngine.profile_latency_model``).
ENGINE_FIT = "engine.fit"

NAMES = (SCHED_NEXT_BATCH, SCHED_ON_ARRIVAL, SCHED_ON_BATCH_DONE, SCHED_ON_DECODE_STEP,
         LOOP_RUN, EXEC_PAD, EXEC_H2D, EXEC_REPLAY, EXEC_CAPTURE, ENGINE_FIT)
# The spans of time that the loop's virtual clock advances by: the charged
# scheduler decision and the whole executor call.
CHARGED = (SCHED_NEXT_BATCH, EXEC_PAD, EXEC_H2D, EXEC_REPLAY, EXEC_CAPTURE)


class SpanLog:
    """Intervals ``(name, start_ns, end_ns, arg)`` in a bounded ring, the
    per-name totals :attr:`calls` and :attr:`ns`, and the counter
    :attr:`queue_wait_ms` (``loop.queue_wait_ms``): each dispatched
    request's wait from its release to its batch's start, on the loop's
    virtual clock, in dispatch order."""

    def __init__(self, capacity: int = 1 << 17):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._ring: list[tuple[str, int, int, int] | None] = [None] * capacity
        self.n = 0  # spans recorded, the overwritten ones included
        self.calls = dict.fromkeys(NAMES, 0)
        self.ns = dict.fromkeys(NAMES, 0)
        self.queue_wait_ms: list[float] = []

    def add(self, name: str, start_ns: int, end_ns: int, arg: int = 0) -> None:
        self.calls[name] += 1  # an unknown name raises here, before anything is kept
        self.ns[name] += end_ns - start_ns
        self._ring[self.n % self.capacity] = (name, start_ns, end_ns, arg)
        self.n += 1

    def close(self, name: str, seconds: float, arg: int = 0) -> None:
        """Record a span that ends now and lasted ``seconds``, as the
        caller's own meter measured it."""
        end = _time.time_ns()  # simlint: ignore[R1] -- stamps the span on the device trace's clock; the sim clock stays virtual
        self.add(name, end - round(seconds * 1e9), end, arg)

    def waited(self, requests: Sequence[Request], start: float) -> None:
        """Count the wait of each request of a batch dispatched at ``start``."""
        self.queue_wait_ms.extend(start - r.release for r in requests)

    @property
    def dropped(self) -> int:
        """Spans overwritten in the ring (their totals are still counted)."""
        return max(0, self.n - self.capacity)

    def intervals(self, names: str | Iterable[str]) -> np.ndarray:
        """The kept spans of ``names``, in the order recorded: (n, 3) int64
        rows of ``start_ns, end_ns, arg``."""
        want = {names} if isinstance(names, str) else set(names)
        if not want <= self.calls.keys():
            raise KeyError(f"unknown span names {sorted(want - self.calls.keys())}")
        if self.n <= self.capacity:
            kept = self._ring[: self.n]
        else:
            i = self.n % self.capacity
            kept = self._ring[i:] + self._ring[:i]
        rows = [s[1:] for s in kept if s[0] in want]
        return np.asarray(rows, np.int64).reshape(-1, 3)

    def covered_ns(self, names: str | Iterable[str], gaps: np.ndarray) -> int:
        """The part of ``gaps``, disjoint (n, 2) ns intervals such as a
        device trace's idle gaps, that lies under the union of the spans of
        ``names``."""
        iv = self.intervals(names)[:, :2]
        gaps = np.asarray(gaps, np.int64).reshape(-1, 2)
        if not len(iv) or not len(gaps):
            return 0
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        ends = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), bool)
        new[1:] = iv[1:, 0] > ends[:-1]
        lo = iv[new, 0]
        hi = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
        before = np.concatenate([[0], np.cumsum(hi - lo)])

        def union_upto(t: np.ndarray) -> np.ndarray:  # the union's measure below t
            j = np.searchsorted(lo, t, side="right") - 1
            inside = np.minimum(t, hi[j]) - lo[j]
            return np.where(j >= 0, before[j] + inside, 0)

        return int((union_upto(gaps[:, 1]) - union_upto(gaps[:, 0])).sum())
