"""ORLOJ's batch-aware distribution-based scheduler (paper §3.2, §4, Alg. 1).

Structure per Algorithm 1:

- one priority queue (dynamic convex hull, :mod:`.hull`) per supported batch
  size ``bs``, holding every pending request still *feasible* at that batch
  size, scored by the Eq.-2 batch-aware priority with the ``L_B(bs)``
  histogram (mixture of all app distributions, §4.3);
- a deadline heap per batch size (the paper uses a Fibonacci heap) driving
  the drop phase (lines 10–14);
- a milestone heap triggering lazy (α, β) re-computation (lines 5–9);
- base-time reset for exponential-overflow handling (lines 2–4, §4.4).

Hot path (DESIGN.md §Hot-path): arrivals are delivered in bulk through
:meth:`OrlojScheduler.on_arrivals` — one :meth:`BinScoreModel.score_many`
pass plus one :meth:`HullQueue.insert_many` block per batch size — and the
full-recompute paths (base reset, profiler snapshot swap) rebuild each hull
with :meth:`HullQueue.bulk_load` from a single vectorized scoring pass.
The distribution algebra behind a snapshot swap is cached: the merged knot
grid is computed once, ``iid_max(mix, bs)`` is one CDF-power per batch size
off a shared knot-CDF, and per-(app, bs) drop-phase estimates are memoized.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Sequence

import numpy as np

from .distributions import (
    BatchLatencyModel,
    EmpiricalDistribution,
    _merged_grid,
    hetero_max,
    iid_max,
    mixture,
)
from .hull import HullQueue
from .priority import DEFAULT_B, RESET_EXPONENT, BinScoreModel, aggregate_steps
from .profiler import OnlineProfiler, ProfilerConfig
from .request import PiecewiseStepCost, Request

__all__ = ["SchedulerConfig", "OrlojScheduler", "MultiModelOrlojScheduler", "Batch"]


def _flatten_steps(
    reqs: Sequence[Request],
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Flatten the requests' SLO cost steps into ``(deadlines, costs,
    seg_starts)`` arrays for :meth:`BinScoreModel.score_many`.

    ``seg_starts`` is ``None`` on the common all-single-step path (rows map
    1:1 to requests); otherwise it holds each request's first row for
    :func:`~repro.core.priority.aggregate_steps`."""
    if all(not r.extra_deadlines for r in reqs):
        d = np.array([r.release + r.slo for r in reqs])
        c = np.array([r.cost for r in reqs])
        return d, c, None
    ds: list[float] = []
    cs: list[float] = []
    starts: list[int] = []
    for r in reqs:
        starts.append(len(ds))
        fn = r.cost_fn()
        steps = fn.steps() if isinstance(fn, PiecewiseStepCost) else [fn]
        for s in steps:
            ds.append(s.deadline)
            cs.append(s.cost)
    return np.array(ds), np.array(cs), np.array(starts)


def _score_flat(
    model: BinScoreModel,
    deadlines: np.ndarray,
    costs: np.ndarray,
    seg_starts: np.ndarray | None,
    t: float,
    base: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-request (α, β, milestone) arrays from flattened step arrays."""
    alpha, beta, milestone = model.score_many(deadlines, costs, t, base)
    if seg_starts is None:
        return alpha, beta, milestone
    return aggregate_steps(alpha, beta, milestone, seg_starts)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    batch_sizes: tuple[int, ...] = (1, 2, 4, 8, 16)
    b: float = DEFAULT_B  # anticipated-delay parameter (§4.1, §5.6)
    n_bins: int = 12
    # 'earliest' = prose of §3.2 (earliest D_Qbs first, larger bs on ties);
    # 'paper_desc' = the literal Algorithm-1 line-16 ordering.
    bs_order: str = "earliest"
    # Refine the drop-phase feasibility estimate with the request's own app
    # distribution: E[max(L_app, L_mix^{bs-1})] instead of E[L_mix^{bs}].
    refine_feasibility: bool = True
    drop_safety: float = 1.0  # scale on EstimateBatchLatency in the drop phase


@dataclasses.dataclass
class Batch:
    """A scheduling decision: the requests to execute at ``batch_size``.

    ``rows`` is an optional columnar annotation for the array engine
    (DESIGN.md §10): the requests' row indices in the run's
    :class:`~repro.core.requeststore.RequestStore`, in batch order.  A
    scheduler fed through ``on_arrivals_cols`` already knows its rows and
    a contiguous ``range`` here turns the engine's per-batch column
    writes into O(1) numpy slice assignments; ``None`` (every existing
    scheduler) means the engine resolves rows itself via
    ``RequestStore.rows_for``.  The scalar loop ignores the field.

    ``decode=True`` marks a *resumable* token-level execution (DESIGN.md
    §12): instead of completing atomically, the batch advances in decode
    steps — requests join at step boundaries via the scheduler's
    ``on_decode_step`` hook and leave at their (data-dependent) EOS step.
    Requires a worker executor exposing ``step_time`` and a scheduler
    implementing the token-mode contract (:mod:`repro.core.tokensched`).

    ``model`` names the zoo model the batch executes (DESIGN.md §13) —
    stamped by model-aware schedulers so a residency-managed event loop
    can charge the load stall before execution.  ``None`` everywhere else.
    """

    requests: list[Request]
    batch_size: int
    rows: "range | list[int] | None" = None
    decode: bool = False
    model: str | None = None

    def __len__(self) -> int:
        return len(self.requests)


class _BsState:
    """Per-batch-size state: hull queue + deadline heap + score model."""

    __slots__ = ("hull", "deadline_heap", "score_model", "est_latency")

    def __init__(self) -> None:
        self.hull = HullQueue()
        self.deadline_heap: list[tuple[float, int]] = []
        self.score_model: BinScoreModel | None = None
        self.est_latency: float = 0.0


class OrlojScheduler:
    """Distribution-aware, batch-aware priority scheduler (Algorithm 1)."""

    name = "orloj"
    # Never reads ``req.started``/``req.finished`` inside its hooks
    # (feedback comes through ``on_batch_done``'s alone-times argument), so
    # the array event loop may defer per-request state writes to the end.
    reads_request_state = False

    def __init__(
        self,
        latency_model: BatchLatencyModel,
        cfg: SchedulerConfig | None = None,
        profiler: OnlineProfiler | None = None,
        initial_dists: dict[str, EmpiricalDistribution] | None = None,
    ) -> None:
        self.cfg = cfg or SchedulerConfig()
        self.latency_model = latency_model
        self.profiler = profiler or OnlineProfiler(ProfilerConfig())
        self._pending: dict[int, Request] = {}
        self._feasible: dict[int, set[int]] = {}  # rid -> feasible batch sizes
        self._bs_state: dict[int, _BsState] = {
            bs: _BsState() for bs in self.cfg.batch_sizes
        }
        self._milestones: list[tuple[float, int, int]] = []  # (time, rid, bs)
        self._base = 0.0
        self._app_dists: dict[str, EmpiricalDistribution] = dict(initial_dists or {})
        self._app_bs_est: dict[tuple[str, int], float] = {}
        self._default_dist = EmpiricalDistribution.delta(10.0)
        self.n_timed_out = 0
        self._rebuild_models()

    # ------------------------------------------------------------------
    # Model (distribution) maintenance
    # ------------------------------------------------------------------
    def _mixture(self) -> EmpiricalDistribution:
        dists = list(self._app_dists.values())
        if not dists:
            self._grid = self._default_dist.edges
            self._grid_exact = True
            return self._default_dist
        # Cache the merged knot grid: every downstream evaluation of the
        # snapshot (mixture CDF, iid-max powers, drop-phase hetero_max)
        # shares it.  ``_grid_exact`` records whether the merge kept every
        # app knot (i.e. no 256-knot subsampling) — only then may the
        # per-app drop estimates reuse it without losing their own knots.
        self._grid, self._grid_exact = _merged_grid(dists)
        return mixture(dists, grid=self._grid)

    def _iid_max_mix(self, k: int) -> EmpiricalDistribution:
        """Memoized ``iid_max(mix, k)`` — the CDF power is one vectorized
        pass over the cached knot CDF, computed at most once per snapshot."""
        got = self._iid_max_cache.get(k)
        if got is None:
            got = iid_max(self._mix, k)
            self._iid_max_cache[k] = got
        return got

    def _rebuild_models(self) -> None:
        """Precompute per-batch-size L_B histograms, score models and
        expected latencies from the current app distributions (§4.3 — this
        is the heavy computation moved off the critical path).  One snapshot
        swap costs one mixture evaluation on the cached grid plus one CDF
        power + hull-ready score model per batch size."""
        mix = self._mixture()
        self._mix = mix
        self._app_bs_est.clear()
        self._iid_max_cache: dict[int, EmpiricalDistribution] = {1: mix}
        for bs, st in self._bs_state.items():
            max_dist = self._iid_max_mix(bs)
            batch_dist = self.latency_model.batch_dist(max_dist, bs)
            st.score_model = BinScoreModel(batch_dist, b=self.cfg.b)
            st.est_latency = self.latency_model.expected_batch_time(mix, bs)

    def estimate_batch_latency(self, req: Request, bs: int) -> float:
        """EstimateBatchLatency(r, bs) — Algorithm 1 line 11."""
        if not self.cfg.refine_feasibility or req.app_id not in self._app_dists:
            return self._bs_state[bs].est_latency
        key = (req.app_id, bs)
        got = self._app_bs_est.get(key)
        if got is None:
            own = self._app_dists[req.app_id]
            if bs == 1:
                max_dist = own
            else:
                # reuse the snapshot's cached knot grid when it is exact
                # (it then contains every knot of `own` and of the mix);
                # a subsampled grid would drop own's knots, so fall back
                # to the per-call merge there
                max_dist = hetero_max(
                    [own, self._iid_max_mix(bs - 1)],
                    grid=self._grid if self._grid_exact else None,
                )
            got = self.latency_model.c0 + self.latency_model.c1 * bs * max_dist.mean()
            self._app_bs_est[key] = got
        return got

    # ------------------------------------------------------------------
    # Arrival / bookkeeping
    # ------------------------------------------------------------------
    def on_arrival(self, req: Request, now: float) -> None:
        self.on_arrivals((req,), now)

    def on_arrivals(self, reqs: Sequence[Request], now: float) -> None:
        """Bulk arrival: score every request at every batch size in one
        vectorized Eq.-2 pass per batch size and insert the new lines as a
        single hull block (the event loop coalesces same-timestamp
        arrivals into one call)."""
        reqs = list(reqs)
        if not reqs:
            return
        deadlines, costs, seg_starts = _flatten_steps(reqs)
        rids = [r.rid for r in reqs]
        all_bs = set(self._bs_state)
        for req, rid in zip(reqs, rids):
            self._pending[rid] = req
            # simlint: ignore[R5] -- per-request feasibility state is the data structure itself, not transient churn; the drop phase mutates it per batch size
            self._feasible[rid] = set(all_bs)
        heap_entries = [(r.release + r.slo, r.rid) for r in reqs]
        for bs, st in self._bs_state.items():
            alpha, beta, miles = _score_flat(
                st.score_model, deadlines, costs, seg_starts, now, self._base
            )
            # simlint: ignore[R5] -- one bulk hull-block load per batch size (not per request); this *is* the PR-2 vectorized path replacing n scalar inserts
            st.hull.insert_many(list(zip(rids, alpha.tolist(), beta.tolist())))
            for entry in heap_entries:
                heapq.heappush(st.deadline_heap, entry)
            for rid, m in zip(rids, miles.tolist()):
                if math.isfinite(m):
                    heapq.heappush(self._milestones, (m, rid, bs))

    def on_arrivals_cols(self, store, lo: int, hi: int, now: float) -> None:
        """Columnar bulk arrival: rows ``[lo, hi)`` of the array engine's
        :class:`~repro.core.requeststore.RequestStore` (store order ==
        release order).  Delegates to :meth:`on_arrivals` over the store's
        request slice — same objects, same scoring pass, bit-identical
        behaviour — so the array loop can hand the scheduler a row range
        without materializing an intermediate list per burst."""
        self.on_arrivals(store.requests[lo:hi], now)

    def on_batch_done(
        self, batch: Batch, now: float, alone_times_ms: Sequence[float]
    ) -> None:
        """Feedback: sampled finished requests go to the async profiler."""
        for req, alone_ms in zip(batch.requests, alone_times_ms):
            self.profiler.observe(req.app_id, alone_ms, now)
        snap = self.profiler.maybe_pickup(now)
        if snap:
            self._app_dists = snap
            self._rebuild_models()
            self._recompute_all(now)

    # ------------------------------------------------------------------
    # Score maintenance (Algorithm 1 lines 1–9)
    # ------------------------------------------------------------------
    def _x(self, now: float) -> float:
        return math.exp(self.cfg.b * (now - self._base))

    def _maybe_reset_base(self, now: float) -> None:
        if self.cfg.b * (now - self._base) > RESET_EXPONENT:
            self._base = now
            self._recompute_all(now)

    def _recompute_all(self, now: float) -> None:
        """Full (α, β) refresh (base reset, snapshot swap): one vectorized
        scoring pass per batch size + an O(n log n) hull bulk load, instead
        of O(pending · |bs|) scalar scores with cascading block merges."""
        self._milestones.clear()
        reqs = list(self._pending.values())
        if not reqs:
            for st in self._bs_state.values():
                st.hull = HullQueue()
            return
        deadlines, costs, seg_starts = _flatten_steps(reqs)
        rids = [r.rid for r in reqs]
        for bs, st in self._bs_state.items():
            alpha, beta, miles = _score_flat(
                st.score_model, deadlines, costs, seg_starts, now, self._base
            )
            lines = []
            for rid, a, b_, m in zip(
                rids, alpha.tolist(), beta.tolist(), miles.tolist()
            ):
                if bs not in self._feasible[rid]:
                    continue
                lines.append((rid, a, b_))
                if math.isfinite(m):
                    heapq.heappush(self._milestones, (m, rid, bs))
            st.hull.bulk_load(lines)

    def _update_due_scores(self, now: float) -> None:
        # Drain every due milestone first, then re-score the affected
        # (rid, bs) pairs batched per batch size.  A freshly computed
        # milestone is strictly in the future up to float rounding; the
        # `> now` guard below keeps an ulp-coincident one from re-entering
        # the heap at the same timestamp.
        due: dict[int, set[int]] = {}
        while self._milestones and self._milestones[0][0] <= now:
            _, rid, bs = heapq.heappop(self._milestones)
            if rid in self._pending and bs in self._feasible.get(rid, ()):
                due.setdefault(bs, set()).add(rid)
        for bs, rid_set in due.items():
            st = self._bs_state[bs]
            rids = sorted(rid_set)  # deterministic re-score order (R4)
            reqs = [self._pending[rid] for rid in rids]
            deadlines, costs, seg_starts = _flatten_steps(reqs)
            alpha, beta, miles = _score_flat(
                st.score_model, deadlines, costs, seg_starts, now, self._base
            )
            for rid, a, b_, m in zip(
                rids, alpha.tolist(), beta.tolist(), miles.tolist()
            ):
                st.hull.update(rid, a, b_)
                if math.isfinite(m) and m > now:
                    heapq.heappush(self._milestones, (m, rid, bs))

    # ------------------------------------------------------------------
    # Drop phase (Algorithm 1 lines 10–14)
    # ------------------------------------------------------------------
    def _drop_phase(self, now: float) -> None:
        for bs, st in self._bs_state.items():
            while st.deadline_heap:
                deadline, rid = st.deadline_heap[0]
                req = self._pending.get(rid)
                if req is None or bs not in self._feasible.get(rid, ()):
                    heapq.heappop(st.deadline_heap)  # lazy removal
                    continue
                est = self.estimate_batch_latency(req, bs) * self.cfg.drop_safety
                if now + est > deadline:
                    heapq.heappop(st.deadline_heap)
                    st.hull.delete(rid)
                    self._feasible[rid].discard(bs)
                    if not self._feasible[rid]:  # line 13–14: timed out
                        self._remove(rid)
                        req.dropped = now
                        self.n_timed_out += 1
                else:
                    break  # heap is deadline-ordered; the rest are feasible

    def _remove(self, rid: int) -> None:
        for bs in sorted(self._feasible.pop(rid, set())):
            st = self._bs_state[bs]
            if rid in st.hull:
                st.hull.delete(rid)
        self._pending.pop(rid, None)

    # ------------------------------------------------------------------
    # Batch selection (Algorithm 1 lines 15–22)
    # ------------------------------------------------------------------
    def _earliest_deadline(self, bs: int) -> float | None:
        st = self._bs_state[bs]
        while st.deadline_heap:
            deadline, rid = st.deadline_heap[0]
            if rid in self._pending and bs in self._feasible.get(rid, ()):
                return deadline
            heapq.heappop(st.deadline_heap)
        return None

    def _prepare(self, now: float) -> tuple[float, int] | None:
        """Alg.-1 maintenance phases + candidate selection, *without*
        popping: returns the winning ``(earliest deadline, batch size)``
        or ``None``.  Split from :meth:`next_batch` so a multi-model
        facade can let per-model queues compete on deadlines before
        committing one of them to a destructive :meth:`_pop`."""
        self._maybe_reset_base(now)
        self._update_due_scores(now)
        self._drop_phase(now)

        candidates: list[tuple[float, int]] = []
        for bs, st in self._bs_state.items():
            d = self._earliest_deadline(bs)
            if d is not None and len(st.hull) >= bs:
                candidates.append((d, bs))
        if not candidates:
            return None
        if self.cfg.bs_order == "paper_desc":
            candidates.sort(key=lambda e: (e[0], e[1]), reverse=True)
        else:  # earliest deadline first, larger batch on ties
            candidates.sort(key=lambda e: (e[0], -e[1]))
        return candidates[0]

    def _pop(self, candidate: int, now: float) -> Batch | None:
        """PopBatch: top ``candidate`` requests by ORLOJ score, in one
        fixed-x top-k pop (avoids k cascading tombstone purges)."""
        x = self._x(now)
        st = self._bs_state[candidate]
        picked: list[Request] = []
        for rid, _val in st.hull.pop_topk(x, candidate):
            req = self._pending[rid]
            picked.append(req)
            self._feasible[rid].discard(candidate)
            self._remove(rid)
        if not picked:
            return None
        return Batch(picked, candidate)

    def next_batch(self, now: float) -> tuple[Batch | None, float | None]:
        """One scheduler iteration.  Returns (batch, next_wake_time)."""
        best = self._prepare(now)
        if best is None:
            wake = self._milestones[0][0] if self._milestones else None
            return None, wake
        batch = self._pop(best[1], now)
        if batch is None:
            return None, None
        return batch, None

    # -- introspection -------------------------------------------------
    @property
    def n_pending(self) -> int:
        return len(self._pending)


class MultiModelOrlojScheduler:
    """One shared Orloj queue over per-model keyed score models (§13).

    Multi-model serving keeps Algorithm 1 intact *per model*: each zoo
    model gets its own :class:`OrlojScheduler` (own ``L_B`` histograms,
    own :class:`~repro.core.priority.BinScoreModel` per batch size, own
    profiler feedback loop), built from that model's scaled per-app
    distributions.  The facade presents the event loop with one queue:
    arrivals route by ``Request.model_id``, and ``next_batch`` lets every
    model's candidate compete on ``(earliest deadline, -batch size)`` —
    the same ordering Alg. 1 uses across batch sizes — before committing
    exactly one inner to a destructive pop.  The winning batch is stamped
    with ``Batch.model`` so a residency-managed event loop can charge the
    weights-load stall before execution.

    Batches never mix models (one set of weights executes at a time), so
    the executor's Eq.-3 batch time stays well-defined per batch.
    """

    name = "orloj-multi"
    # Same contract as OrlojScheduler: feedback arrives via on_batch_done,
    # never by reading request bookkeeping fields.
    reads_request_state = False

    def __init__(
        self,
        latency_model: BatchLatencyModel,
        initial_dists_by_model: dict[str, dict[str, EmpiricalDistribution]],
        cfg: SchedulerConfig | None = None,
    ) -> None:
        if not initial_dists_by_model:
            raise ValueError("multi-model scheduler needs at least one model")
        self.cfg = cfg or SchedulerConfig()
        self.latency_model = latency_model
        self._inner: dict[str, OrlojScheduler] = {
            m: OrlojScheduler(latency_model, cfg=self.cfg, initial_dists=dists)
            for m, dists in initial_dists_by_model.items()
        }

    def _route(self, req: Request) -> OrlojScheduler:
        sched = self._inner.get(req.model_id)
        if sched is None:
            raise ValueError(
                f"request {req.rid} targets unknown model {req.model_id!r} "
                f"(scheduler serves {sorted(self._inner)})"
            )
        return sched

    # -- arrival / feedback hooks --------------------------------------
    def on_arrival(self, req: Request, now: float) -> None:
        self._route(req).on_arrivals((req,), now)

    def on_arrivals(self, reqs: Sequence[Request], now: float) -> None:
        by_model: dict[str, list[Request]] = {}
        for r in reqs:
            self._route(r)  # loud on unknown/unset model ids
            by_model.setdefault(r.model_id, []).append(r)
        for m, group in by_model.items():
            self._inner[m].on_arrivals(group, now)

    def on_arrivals_cols(self, store, lo: int, hi: int, now: float) -> None:
        self.on_arrivals(store.requests[lo:hi], now)

    def on_batch_done(
        self, batch: Batch, now: float, alone_times_ms: Sequence[float]
    ) -> None:
        if batch.model is None:
            raise ValueError("multi-model batch completed without a model id")
        self._inner[batch.model].on_batch_done(batch, now, alone_times_ms)

    # -- batch selection ------------------------------------------------
    def next_batch(self, now: float) -> tuple[Batch | None, float | None]:
        best: tuple[float, int, int] | None = None
        best_model: str | None = None
        for i, (m, sched) in enumerate(self._inner.items()):
            cand = sched._prepare(now)
            if cand is None:
                continue
            # deadline, larger batch on ties, then model roster order —
            # a total order, so the winner is deterministic
            key = (cand[0], -cand[1], i)
            if best is None or key < best:
                best, best_model = key, m
        if best_model is None:
            wakes = [
                s._milestones[0][0] for s in self._inner.values() if s._milestones
            ]
            return None, (min(wakes) if wakes else None)
        batch = self._inner[best_model]._pop(-best[1], now)
        if batch is None:
            return None, None
        batch.model = best_model
        return batch, None

    # -- introspection --------------------------------------------------
    @property
    def n_pending(self) -> int:
        return sum(s.n_pending for s in self._inner.values())

    @property
    def n_timed_out(self) -> int:
        return sum(s.n_timed_out for s in self._inner.values())
