"""Dynamic convex-hull priority queue (paper §4.4).

Each pending request is a line ``p(x) = α·x + β`` with ``x = e^{b(t−base)}``
(Eq. 2 rewritten, §4.4).  The top-priority request at time ``t`` is the line
maximising ``α·x + β`` — the first point of the upper convex hull hit by a
sweep line of slope ``−x``.

The paper implements Overmars–van Leeuwen (O(log² n) fully-dynamic hulls)
with a hand-rolled 2-3-tree concatenable queue.  We use the *logarithmic
method* (Bentley–Saxe) instead: O(log n) static convex-hull-trick blocks of
geometrically increasing size, lazy deletion with purge-on-hit, and global
compaction once half the structure is tombstones.  Insert is O(log n)
amortised, query O(log² n) — the same asymptotics the paper reports for its
queue (Fig. 12), with a far simpler implementation (see DESIGN.md
§Substitutions).
"""

from __future__ import annotations

import bisect
import math
from typing import Hashable, Iterable, Sequence

import numpy as np

__all__ = ["HullQueue"]


class _Block:
    """Static convex-hull-trick structure for max(α·x + β) over x > 0."""

    __slots__ = ("lines", "hull_keys", "hull_alpha", "hull_beta", "breaks")

    def __init__(self, lines: Sequence[tuple[Hashable, float, float]]):
        # lines: (key, alpha, beta)
        self.lines = list(lines)
        pts = sorted(self.lines, key=lambda e: (e[1], e[2]))
        # Deduplicate equal slopes, keeping the max intercept.
        dedup: list[tuple[Hashable, float, float]] = []
        for e in pts:
            if dedup and dedup[-1][1] == e[1]:
                dedup[-1] = e  # e has >= beta due to sort
            else:
                dedup.append(e)
        hull: list[tuple[Hashable, float, float]] = []
        for e in dedup:
            while len(hull) >= 2 and self._bad(hull[-2], hull[-1], e):
                hull.pop()
            hull.append(e)
        self.hull_keys = [e[0] for e in hull]
        self.hull_alpha = [e[1] for e in hull]
        self.hull_beta = [e[2] for e in hull]
        # breaks[i] = x at which hull[i+1] overtakes hull[i]
        self.breaks = [
            (self.hull_beta[i] - self.hull_beta[i + 1])
            / (self.hull_alpha[i + 1] - self.hull_alpha[i])
            for i in range(len(hull) - 1)
        ]

    @staticmethod
    def _bad(
        a: tuple[int, float, float],
        b: tuple[int, float, float],
        c: tuple[int, float, float],
    ) -> bool:
        # b is never the max if c overtakes a no later than b does.
        #   (c_beta - a_beta)/(a_alpha - c_alpha) <= (b_beta - a_beta)/(a_alpha - b_alpha)
        return (c[2] - a[2]) * (b[1] - a[1]) >= (b[2] - a[2]) * (c[1] - a[1])

    def __len__(self) -> int:
        return len(self.lines)

    def argmax(self, x: float) -> tuple[Hashable, float]:
        i = bisect.bisect_right(self.breaks, x)
        return self.hull_keys[i], self.hull_alpha[i] * x + self.hull_beta[i]


class HullQueue:
    """Fully-dynamic max-envelope queue over lines ``α·x + β``.

    Operations: ``insert(key, α, β)``, ``delete(key)``, ``update``,
    ``argmax(x)`` / ``value(key, x)``.  Lazy deletion: a tombstoned line that
    surfaces as a block argmax triggers a purge-rebuild of that block; a
    global compaction runs once tombstones outnumber live lines.
    """

    def __init__(self) -> None:
        self._alive: dict[Hashable, tuple[float, float]] = {}
        self._blocks: list[_Block] = []
        self._dead = 0

    def __len__(self) -> int:
        return len(self._alive)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._alive

    def keys(self) -> Iterable[Hashable]:
        return self._alive.keys()

    # -- mutation ----------------------------------------------------------
    def insert(self, key: Hashable, alpha: float, beta: float) -> None:
        if key in self._alive:
            raise KeyError(f"duplicate key {key!r}")
        if not (math.isfinite(alpha) and math.isfinite(beta)):
            raise ValueError("non-finite line coefficients (overflow guard)")
        self._alive[key] = (alpha, beta)
        self._push_block([(key, alpha, beta)])

    def insert_many(
        self, items: Iterable[tuple[Hashable, float, float]]
    ) -> None:
        """Insert many lines as ONE static block: a single O(n log n) hull
        build instead of n cascading binary-counter merges (the arrival-path
        bulk load, DESIGN.md §Hot-path).  All-or-nothing: validates every
        item before touching the structure."""
        items = list(items)
        seen: set[Hashable] = set()
        for key, alpha, beta in items:
            if key in self._alive or key in seen:
                raise KeyError(f"duplicate key {key!r}")
            seen.add(key)
            if not (math.isfinite(alpha) and math.isfinite(beta)):
                raise ValueError("non-finite line coefficients (overflow guard)")
        if not items:
            return
        for key, alpha, beta in items:
            self._alive[key] = (alpha, beta)
        self._push_block(items)

    def bulk_load(
        self, items: Iterable[tuple[Hashable, float, float]]
    ) -> None:
        """Discard all current lines and load ``items`` as one block — the
        O(n log n) full-rebuild path (base reset / profiler snapshot swap)."""
        self._alive.clear()
        self._blocks = []
        self._dead = 0
        self.insert_many(items)

    def delete(self, key: Hashable) -> None:
        del self._alive[key]
        self._dead += 1
        if self._dead > max(8, len(self._alive)):
            self._compact()

    def update(self, key: Hashable, alpha: float, beta: float) -> None:
        """Replace ``key``'s line in place: overwrite the live coefficients
        (the stale block entry tombstones lazily via the ``_is_alive``
        check) and push the new line, without the delete+insert round trip
        and its early compaction churn."""
        cur = self._alive.get(key)
        if cur is None:
            raise KeyError(key)
        if cur == (alpha, beta):
            return  # no-op: the live block entry is already this line
        if not (math.isfinite(alpha) and math.isfinite(beta)):
            raise ValueError("non-finite line coefficients (overflow guard)")
        self._alive[key] = (alpha, beta)
        self._dead += 1  # the superseded copy lingering in its block
        self._push_block([(key, alpha, beta)])
        if self._dead > max(8, len(self._alive)):
            self._compact()

    def _push_block(self, lines: list[tuple[int, float, float]]) -> None:
        self._blocks.append(_Block(lines))
        # Binary-counter merging keeps O(log n) blocks, geometric sizes.
        while (
            len(self._blocks) >= 2
            and len(self._blocks[-2]) <= 2 * len(self._blocks[-1])
        ):
            b = self._blocks.pop()
            a = self._blocks.pop()
            merged = [e for e in (a.lines + b.lines) if self._is_alive(e)]
            if merged:
                self._blocks.append(_Block(merged))

    def _is_alive(self, e: tuple[Hashable, float, float]) -> bool:
        v = self._alive.get(e[0])
        return v is not None and v == (e[1], e[2])

    def _compact(self) -> None:
        lines = [(k, a, b) for k, (a, b) in self._alive.items()]
        self._blocks = []
        self._dead = 0
        if lines:
            self._blocks.append(_Block(lines))

    # -- queries -----------------------------------------------------------
    def value(self, key: Hashable, x: float) -> float:
        a, b = self._alive[key]
        return a * x + b

    def argmax(self, x: float) -> tuple[Hashable, float] | None:
        """Return (key, value) of the live line maximising α·x + β."""
        best_key: Hashable | None = None
        best_val = -math.inf
        i = 0
        while i < len(self._blocks):
            blk = self._blocks[i]
            j = bisect.bisect_right(blk.breaks, x)
            key = blk.hull_keys[j]
            coeffs = (blk.hull_alpha[j], blk.hull_beta[j])
            if self._alive.get(key) != coeffs:
                # Tombstone (deleted, or stale coefficients after an update)
                # surfaced as this block's argmax: purge the block and retry.
                live = [e for e in blk.lines if self._is_alive(e)]
                if live:
                    self._blocks[i] = _Block(live)
                else:
                    self._blocks.pop(i)
                continue
            val = coeffs[0] * x + coeffs[1]
            if val > best_val:
                best_key, best_val = key, val
            i += 1
        if best_key is None:
            return None
        return best_key, best_val

    def pop_max(self, x: float) -> tuple[Hashable, float] | None:
        got = self.argmax(x)
        if got is None:
            return None
        self.delete(got[0])
        return got

    def pop_topk(self, x: float, k: int) -> list[tuple[Hashable, float]]:
        """Pop the (up to) k live lines maximising ``α·x + β`` at one fixed
        ``x``, best first.

        PopBatch pops at a *single* sweep position, so the top-k reduces to
        one vectorized O(n) value scan + argpartition.  Popping through the
        hull instead would surface a fresh tombstone at the top of the
        largest block on every pop and pay k near-full purge rebuilds
        (DESIGN.md §Hot-path); the envelope machinery is only worth it for
        queries at varying ``x``.
        """
        n = len(self._alive)
        if k <= 0 or n == 0:
            return []
        if k == 1 or n <= 4:
            out = []
            for _ in range(min(k, n)):
                got = self.pop_max(x)
                if got is None:
                    break
                out.append(got)
            return out
        keys = list(self._alive)
        coef = np.array(list(self._alive.values()))
        vals = coef[:, 0] * x + coef[:, 1]
        k = min(k, n)
        idx = np.argpartition(-vals, k - 1)[:k]
        idx = idx[np.argsort(-vals[idx], kind="stable")]
        out = [(keys[i], float(vals[i])) for i in idx]
        for key, _ in out:
            self.delete(key)
        return out
