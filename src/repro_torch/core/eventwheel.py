"""Bucketed calendar-queue event wheel (the dynamic half of the array
engine's event sourcing; DESIGN.md §10).

The array-backed event loop splits the classic event heap in two:

- the *static* half — every ARRIVAL is known up front, so arrivals live
  in the :class:`~repro.core.requeststore.RequestStore` as sorted numpy
  columns with precomputed same-timestamp group boundaries and never
  touch a priority queue at all;
- the *dynamic* half — DONE/WAKE events created while the simulation
  runs.  That is this module.  At any instant the loop holds at most a
  couple of live events per worker (one in-flight batch, one live wake,
  plus superseded wakes waiting to fire as no-ops), so the wheel is
  engineered for *cheap steady-state churn*, not capacity.

Design (a classic calendar queue, Brown 1988, adapted):

- events hash into fixed-width time buckets ``floor(t / bucket_ms)``;
  buckets are a sparse ``dict`` keyed by integer bucket index, plus a
  lazy min-heap of nonempty bucket indices (a popped index may be stale
  — re-checked against the dict, exactly like tombstoned heap entries);
- :meth:`pop_bucket` drains one whole bucket at a time, sorted by
  ``(time, seq)`` — the pop-all-events-in-a-bucket operation the array
  loop's batched DONE/WAKE processing is built on;
- total order across buckets and within a bucket is identical to a
  ``heapq`` over ``(time, seq)`` tuples (property-tested, including
  same-timestamp coalescing and bucket-boundary edges);
- **heapq fallback for pathological spreads**: an event whose timestamp
  cannot be bucketed meaningfully — non-finite, or so far from the
  current window that its bucket index overflows :data:`MAX_BUCKET_SPAN`
  buckets — goes to an overflow heap that is merged back in timestamp
  order on pop.  A wheel constructed with ``bucket_ms=None`` degenerates
  entirely to that heap (used when the caller has no spread estimate).

``seq`` is the caller-supplied tiebreaker: the array loop numbers
arrivals ``0..n-1`` at build time and keeps counting for DONE/WAKE
pushes, so at equal timestamps arrivals always precede the dynamic
events pushed later — the same total order the scalar loop's
``(time, seq, kind, payload)`` heap produces.
"""

from __future__ import annotations

import heapq
import math
from typing import Any, Iterator

__all__ = ["EventWheel", "MAX_BUCKET_SPAN"]

# An event farther than this many buckets from the current cursor is
# "pathologically spread" and goes to the overflow heap instead of a
# dict entry (keeps the bucket-index heap small when a trace mixes
# ms-scale churn with, say, an hours-away timeout).
MAX_BUCKET_SPAN = 1 << 20

_Event = tuple[float, int, int, Any]  # (time, seq, kind, payload)


class EventWheel:
    """Calendar queue over ``(time, seq, kind, payload)`` events.

    ``bucket_ms`` is the bucket width; ``None`` means pure-heapq mode.
    Pops must be non-decreasing in time (discrete-event contract); pushes
    may land in the current bucket at or after the last popped time —
    pushing strictly *before* the last pop is a caller bug and raises.
    """

    __slots__ = ("bucket_ms", "_buckets", "_bucket_heap", "_overflow",
                 "_cursor", "_last_time", "_n")

    def __init__(self, bucket_ms: float | None = None) -> None:
        if bucket_ms is not None and not (bucket_ms > 0.0):
            raise ValueError(f"bucket_ms must be positive, got {bucket_ms}")
        self.bucket_ms = bucket_ms
        self._buckets: dict[int, list[_Event]] = {}
        self._bucket_heap: list[int] = []  # lazy: may hold stale indices
        self._overflow: list[_Event] = []  # heapq fallback
        self._cursor = 0  # bucket index of the last pop (window anchor)
        self._last_time = -math.inf
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    # ------------------------------------------------------------- push
    def push(self, time: float, seq: int, kind: int, payload: Any) -> None:
        if time < self._last_time:
            raise ValueError(
                f"event at t={time} pushed before the wheel's last pop "
                f"t={self._last_time} (discrete-event order violated)"
            )
        ev = (time, seq, kind, payload)
        self._n += 1
        if self.bucket_ms is not None and math.isfinite(time):
            idx = int(time // self.bucket_ms)
            if abs(idx - self._cursor) <= MAX_BUCKET_SPAN:
                got = self._buckets.get(idx)
                if got is None:
                    self._buckets[idx] = [ev]
                    heapq.heappush(self._bucket_heap, idx)
                else:
                    got.append(ev)
                return
        heapq.heappush(self._overflow, ev)  # pathological spread / no width

    # ------------------------------------------------------------- peek
    def _min_bucket(self) -> int | None:
        """Smallest nonempty bucket index (drops stale heap entries)."""
        heap = self._bucket_heap
        while heap:
            idx = heap[0]
            if idx in self._buckets:
                return idx
            heapq.heappop(heap)  # stale: bucket already drained
        return None

    def peek_time(self) -> float:
        """Earliest event timestamp (``inf`` when empty)."""
        return self.peek_key()[0]

    def peek_key(self) -> tuple[float, int]:
        """``(time, seq)`` of the earliest event (``(inf, -1)`` when empty).

        The caller's merge key: the array loop compares this against the
        head of its in-hand bucket batch and against the next arrival
        group to keep the global ``(time, seq)`` order while events pushed
        *during* a batch land back in the wheel."""
        best: _Event | None = None
        idx = self._min_bucket()
        if idx is not None:
            # seqs are unique, so min() never compares beyond (time, seq)
            best = min(self._buckets[idx])
        if self._overflow:
            o = self._overflow[0]
            if best is None or o < best:
                best = o
        if best is None:
            return (math.inf, -1)
        return (best[0], best[1])

    # -------------------------------------------------------------- pop
    def pop_bucket(self) -> list[_Event]:
        """Drain the earliest nonempty bucket, sorted by ``(time, seq)``.

        The returned batch is exactly the events of one calendar bucket
        (overflow events that fall inside that bucket's window included),
        so the caller amortizes its per-event bookkeeping over the whole
        bucket.  Raises ``IndexError`` when empty.

        ``_last_time`` advances to the *first* event of the batch, not the
        last: while the caller works through the batch its handlers may
        push fresh events timestamped between the remaining batch entries
        (a DONE handler arming a WAKE inside the same bucket window) —
        those re-enter the wheel, recreate the drained bucket index if
        needed, and surface through :meth:`peek_key` so the caller's merge
        keeps the global order.
        """
        if self._n == 0:
            raise IndexError("pop from an empty EventWheel")
        idx = self._min_bucket()
        batch: list[_Event]
        if idx is None:
            # heap-only mode (or everything in overflow): one timestamp's
            # worth of events forms the "bucket".
            batch = [heapq.heappop(self._overflow)]
            t0 = batch[0][0]
            while self._overflow and self._overflow[0][0] == t0:
                batch.append(heapq.heappop(self._overflow))
        else:
            batch = self._buckets.pop(idx)
            heapq.heappop(self._bucket_heap)  # idx is the live minimum
            # merge overflow events that belong to this bucket's window
            assert self.bucket_ms is not None
            end = (idx + 1) * self.bucket_ms
            while self._overflow and self._overflow[0][0] < end:
                batch.append(heapq.heappop(self._overflow))
            batch.sort()
            self._cursor = idx
        self._n -= len(batch)
        self._last_time = batch[0][0]
        return batch

    def pop(self) -> _Event:
        """Pop the single earliest event — total order ≡ ``heapq`` over
        ``(time, seq)``.  Implemented as a tiny front-buffer over
        :meth:`pop_bucket`-style draining so mixed pop/pop_bucket use is
        still globally ordered."""
        if self._n == 0:
            raise IndexError("pop from an empty EventWheel")
        idx = self._min_bucket()
        if idx is not None:
            bucket = self._buckets[idx]
            ev = min(bucket)
            if self._overflow and self._overflow[0] < ev:
                ev = heapq.heappop(self._overflow)
            else:
                bucket.remove(ev)
                if not bucket:
                    del self._buckets[idx]
                else:
                    self._cursor = idx
        else:
            ev = heapq.heappop(self._overflow)
        self._n -= 1
        self._last_time = ev[0]
        return ev

    def drain(self) -> Iterator[_Event]:
        """Pop everything in order (test/debug helper)."""
        while self._n:
            yield from self.pop_bucket()
