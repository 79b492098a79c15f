"""Struct-of-arrays request store (the static half of the array engine's
event sourcing; DESIGN.md §10).

A trace's arrivals are fully known before the simulation starts, so the
array-backed event loop never materializes them as heap entries.
:class:`RequestStore` is built **once per trace**: the request sequence is
stable-sorted by release time and its per-request scalars become numpy
columns — ``release``/``deadline``/``true_time`` read-only inputs,
``started``/``finished`` NaN-initialized state columns the loop writes
with fancy indexing per *batch*, not per request.  Same-timestamp groups
(the coalescing windows the bulk ``on_arrivals`` path feeds on) are
precomputed as plain-int boundaries, so the loop's arrival cursor is two
list indexes per group instead of a heap pop per event.

The :class:`~repro.core.request.Request` objects themselves stay around
(``self.requests``, in store order): they are the scheduler-facing
currency — ``on_arrivals`` delivery, drop-phase bookkeeping (schedulers
write ``req.dropped``), batch payloads for the executor.  What the store
eliminates is the *event engine's* per-request object churn: heap tuples,
per-event attribute writes, and the end-of-run per-object stats pass
(counts/latencies fold vectorized from the columns instead).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .request import Request

__all__ = ["RequestStore"]


class RequestStore:
    """Columnar view over one trace, sorted by release time (stable)."""

    __slots__ = ("requests", "release", "deadline", "true_time", "started",
                 "finished", "group_starts", "group_times", "_row",
                 "_rowbase")

    def __init__(self, requests: Sequence[Request]) -> None:
        n = len(requests)
        # One listcomp per column (C-speed np.array over a plain list beats
        # fromiter-over-generator ~3x; the store build is itself on the
        # per-trace critical path at 10⁵–10⁶ requests).
        release = np.array([r.release for r in requests], dtype=np.float64)
        if n == 0 or bool(np.all(release[:-1] <= release[1:])):
            # Already in release order (every generated trace is — arrivals
            # come from a cumsum): skip the argsort and the reorder pass.
            self.requests = list(requests)
            self.release = release
        else:
            # Stable sort ≡ ``sorted(requests, key=lambda r: r.release)`` —
            # the scalar loop's ordering, so stats fold identically.
            order = np.argsort(release, kind="stable")
            self.requests = [requests[i] for i in order.tolist()]
            self.release = release[order]
        self.true_time = np.array(
            [r.true_time for r in self.requests], dtype=np.float64
        )
        slo = np.array([r.slo for r in self.requests], dtype=np.float64)
        # Same float op as ``Request.deadline`` (release + slo): comparisons
        # against the column are bit-identical to the property.
        self.deadline = self.release + slo
        self.started = np.full(n, np.nan)
        self.finished = np.full(n, np.nan)
        # Same-timestamp group boundaries: group g is the half-open row
        # range [group_starts[g], group_starts[g+1]) and every row in it
        # bears release == group_times[g].  Plain Python ints/floats —
        # the loop indexes these every iteration and ``list[int]`` beats
        # numpy scalar extraction on that path.
        if n:
            change = np.flatnonzero(np.diff(self.release)) + 1
            starts = np.concatenate(([0], change, [n]))
        else:
            starts = np.array([0], dtype=np.intp)
        self.group_starts: list[int] = [int(i) for i in starts]
        self.group_times: list[float] = [
            float(t) for t in self.release[starts[:-1]]
        ]
        # (rid - base) -> row, built lazily on the first batch dispatch: an
        # overloaded trace dispatches few of its requests, and the eager
        # map build was a measurable slice of store construction.
        self._row: list[int] | dict[int, int] | None = None
        self._rowbase = 0

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def n_groups(self) -> int:
        return len(self.group_times)

    def group(self, g: int) -> list[Request]:
        """The requests of same-timestamp group ``g`` (store order)."""
        return self.requests[self.group_starts[g]:self.group_starts[g + 1]]

    def rows_for(self, requests: Sequence[Request]) -> list[int]:
        """Store rows for a batch's requests (rids are global counters,
        not store indices — hence the map)."""
        row = self._row
        if row is None:
            row = self._build_rowmap()
        base = self._rowbase
        return [row[r.rid - base] for r in requests]

    def _build_rowmap(self) -> list[int] | dict[int, int]:
        """Row lookup keyed by ``rid - base``.  Request ids come from one
        global counter, so any trace built in one go (``generate_requests``,
        ``RequestSet.fresh()``) has a *contiguous* rid range — then the map
        is a flat list filled by one vectorized scatter instead of a
        100k-entry dict comprehension.  Arbitrary rid sets fall back to a
        dict with the same ``rid - base`` keying."""
        reqs = self.requests
        n = len(reqs)
        rids = np.array([r.rid for r in reqs], dtype=np.int64)
        base = int(rids.min()) if n else 0
        row: list[int] | dict[int, int]
        if n and int(rids.max()) - base + 1 == n:
            # rids are unique (global counter), so span == n ⇒ contiguous
            scatter = np.empty(n, dtype=np.int64)
            scatter[rids - base] = np.arange(n)
            row = scatter.tolist()
        else:
            row = {int(rid) - base: i for i, rid in enumerate(rids.tolist())}
        self._rowbase = base
        self._row = row
        return row

    # ------------------------------------------------------------- stats
    def fold_stats(
        self, no_drops: bool = False, n_off_ledger: int = 0
    ) -> tuple[int, int, int, int, np.ndarray]:
        """Vectorized end-of-run accounting from the state columns:
        ``(ok, late, dropped, unserved, latencies)``, bit-identical to the
        scalar loop's per-object pass (same floats, same store order).

        ``dropped`` is the one per-object read left: schedulers mark
        timeouts by writing ``req.dropped`` (their own bookkeeping), so the
        store has no column for it — one O(n) predicate scan at fold time,
        off the hot path.  The caller may pass ``no_drops=True`` when it
        has *proven* nothing was dropped (every scheduler in the pool
        exposes an ``n_timed_out`` counter, incremented alongside every
        ``req.dropped`` write, and all read zero) — that skips the scan.

        ``n_off_ledger`` is the count of requests the fault tier resolved
        *outside* the columns (admission-rejected or retry-exhausted
        ``failed`` — both look unfinished-and-undropped here): they are
        subtracted from ``unserved`` so the caller's terminal-state
        accounting conserves every request exactly once."""
        n = len(self.requests)
        fin = self.finished
        finished_mask = ~np.isnan(fin)
        ok_mask = finished_mask & (fin <= self.deadline)
        ok = int(np.count_nonzero(ok_mask))
        n_finished = int(np.count_nonzero(finished_mask))
        late = n_finished - ok
        if no_drops:
            dropped = 0
            unserved = n - n_finished - n_off_ledger
        else:
            dropped_mask = np.fromiter(
                (r.dropped is not None for r in self.requests),
                dtype=bool,
                count=n,
            )
            dropped = int(np.count_nonzero(dropped_mask))
            unserved = (
                int(np.count_nonzero(~finished_mask & ~dropped_mask))
                - n_off_ledger
            )
        latencies = (fin - self.release)[finished_mask]
        return ok, late, dropped, unserved, latencies

    def writeback(self) -> None:
        """Flush the ``started``/``finished`` columns onto the Request
        objects — one O(n) pass after the run, so downstream consumers
        (tests, the engine sim-twin) see the same per-object state the
        scalar loop leaves behind."""
        for r, s, f in zip(
            self.requests, self.started.tolist(), self.finished.tolist()
        ):
            if s == s:  # not NaN
                r.started = s
            if f == f:
                r.finished = f
