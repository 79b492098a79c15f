"""Multi-worker scale-out (paper §3.1: "to scale out to a pool of workers
in a cluster setting, different models and their replicas can use ORLOJ in
parallel") — flat pools and the two-level fleet mode.

The replica-pool loop is the N-worker case of the unified engine in
:mod:`repro.core.eventloop`; :func:`simulate_cluster` keeps the historical
call shape (a list of schedulers sharing one executor).  For heterogeneous
pools — per-replica executors, different latency models — build
:class:`~repro.core.eventloop.Worker` pairs and call
:func:`~repro.core.eventloop.run_event_loop` directly.

Flat dispatch policies (see :data:`repro.core.eventloop.DISPATCH_POLICIES`):
``least_loaded``, ``round_robin``, ``jsq_work``, ``p2c``.

**Fleet mode** (DESIGN.md §10): real serving fleets don't run one router
over 10³ replicas — a front-end tier picks a *pool* from cheap aggregate
load signals, and a pool-local router places the request on a replica.
:func:`hierarchical_policy` builds exactly that as a standard event-loop
dispatch callable: the worker list is partitioned into ``n_pools``
contiguous pools; the *inter* level (``p2c``/``jsq_work``/``round_robin``)
chooses a pool from per-pool aggregated backlog (Σ expected queued work,
Σ queue length), and the *intra* level (any flat policy name) chooses the
replica inside the winning pool.  ``p2c`` between pools is the
fleet-realistic default — two aggregate load probes per arrival, never a
full fleet scan — while every replica keeps running its own scheduler
(Orloj within each pool in the paper's framing).
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np

from ..core.eventloop import (
    DISPATCH_POLICIES,
    Executor,
    SimResult,
    Worker,
    run_event_loop,
)
from ..core.request import Request
from .faults import FaultPlan
from .residency import ResidencyPlan

__all__ = [
    "DISPATCH_POLICIES",
    "INTER_POOL_POLICIES",
    "ResidencyPlan",
    "Worker",
    "hierarchical_policy",
    "run_event_loop",
    "run_fleet",
    "simulate_cluster",
]

# Front-end (inter-pool) policy names understood by hierarchical_policy.
INTER_POOL_POLICIES = ("p2c", "jsq_work", "round_robin")


def pool_bounds(n_workers: int, n_pools: int) -> list[tuple[int, int]]:
    """Contiguous ``[lo, hi)`` worker ranges of the ``n_pools`` pools, as
    even as possible (the first ``n_workers % n_pools`` pools get one
    extra replica)."""
    if not 1 <= n_pools <= n_workers:
        raise ValueError(
            f"need 1 <= n_pools <= n_workers, got {n_pools} pools over "
            f"{n_workers} workers"
        )
    base, rem = divmod(n_workers, n_pools)
    bounds = []
    lo = 0
    for p in range(n_pools):
        hi = lo + base + (1 if p < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def hierarchical_policy(
    n_workers: int,
    n_pools: int,
    inter: str = "p2c",
    intra: str = "round_robin",
    seed: int = 0,
) -> Callable:
    """Two-level fleet dispatch as an event-loop policy callable.

    The returned ``pick(request, now, pool)`` first selects a pool from
    aggregated backlog (``inter``: one of :data:`INTER_POOL_POLICIES`),
    then a replica within it (``intra``: any flat
    :data:`~repro.core.eventloop.DISPATCH_POLICIES` name).  Aggregate
    backlog of a pool is ``(Σ queued_work, Σ (n_pending + busy +
    pending_offset))`` over its replicas — the same signals the flat
    policies read, summed; ``p2c`` probes two pools, ``jsq_work`` scans
    all of them, ``round_robin`` rotates blindly.

    The policy owns its RNG (seeded by ``seed``), so a fleet run's
    dispatch sequence is deterministic and independent of the event
    loop's own rng consumption.
    """
    if inter not in INTER_POOL_POLICIES:
        raise ValueError(
            f"unknown inter-pool policy {inter!r}; known: "
            f"{list(INTER_POOL_POLICIES)}"
        )
    if intra not in DISPATCH_POLICIES:
        raise ValueError(
            f"unknown intra-pool policy {intra!r}; known: "
            f"{sorted(DISPATCH_POLICIES)}"
        )
    bounds = pool_bounds(n_workers, n_pools)
    rng = np.random.default_rng(seed)
    inter_rr = itertools.cycle(range(n_pools))
    intra_rr = [itertools.cycle(range(lo, hi)) for lo, hi in bounds]

    def pool_backlog(pool, p: int) -> tuple[float, float]:
        lo, hi = bounds[p]
        qw = pool.queued_work
        busy = pool.busy
        off = pool.pending_offset
        work = 0.0
        length = 0.0
        for w in range(lo, hi):
            work += qw[w]
            length += (
                getattr(pool.workers[w].scheduler, "n_pending", 0)
                + busy[w]
                + off[w]
            )
        return (work, length)

    def pick_pool(pool) -> int:
        if n_pools == 1:
            return 0
        if inter == "round_robin":
            return next(inter_rr)
        if inter == "p2c":
            i, j = rng.choice(n_pools, size=2, replace=False)
            i, j = int(i), int(j)
            return i if pool_backlog(pool, i) <= pool_backlog(pool, j) else j
        # jsq_work: full scan over pool aggregates
        best, best_key = 0, pool_backlog(pool, 0)
        for p in range(1, n_pools):
            key = pool_backlog(pool, p)
            if key < best_key:
                best, best_key = p, key
        return best

    def pick_worker(req: Request, now: float, pool, p: int) -> int:
        lo, hi = bounds[p]
        if hi - lo == 1:
            return lo
        if intra == "round_robin":
            return next(intra_rr[p])
        if intra == "residency":
            # Residency before backlog, within the winning pool (DESIGN.md
            # §13): a replica already holding the request's weights beats
            # any warmer-queued cold one; ties fall back to least backlog.
            res = pool.residency
            best, best_key = lo, None
            for w in range(lo, hi):
                load = (
                    getattr(pool.workers[w].scheduler, "n_pending", 0)
                    + pool.busy[w]
                    + pool.pending_offset[w]
                )
                hit = (
                    res is not None
                    and req.model_id is not None
                    and res.resident(w, req.model_id)
                )
                key = (not hit, load, w)
                if best_key is None or key < best_key:
                    best, best_key = w, key
            return best
        if intra == "p2c":
            i, j = rng.choice(hi - lo, size=2, replace=False)
            i, j = lo + int(i), lo + int(j)
            return i if pool.backlog(i) <= pool.backlog(j) else j
        if intra == "jsq_work":
            qw = pool.queued_work
            best, best_w = lo, qw[lo]
            for w in range(lo + 1, hi):
                if qw[w] < best_w:
                    best, best_w = w, qw[w]
            return best
        # least_loaded with rng tie-break, matching the flat policy's shape
        loads = np.array(
            [
                getattr(pool.workers[w].scheduler, "n_pending", 0)
                + pool.busy[w]
                + pool.pending_offset[w]
                for w in range(lo, hi)
            ]
        )
        cands = np.flatnonzero(loads == loads.min())
        return lo + int(rng.choice(cands))

    def pick(req: Request, now: float, pool) -> int:
        return pick_worker(req, now, pool, pick_pool(pool))

    return pick


def run_fleet(
    requests: Sequence[Request],
    workers: Sequence[Worker],
    *,
    n_pools: int,
    inter: str = "p2c",
    intra: str = "round_robin",
    seed: int = 0,
    engine: str = "array",
    horizon: float | None = None,
    faults: "FaultPlan | None" = None,
    residency: "ResidencyPlan | None" = None,
    wall_budget_s: float = 0.0,
) -> SimResult:
    """Drive a two-level fleet: ``inter`` routing across ``n_pools``
    contiguous pools of ``workers``, ``intra`` within the winning pool.
    Defaults to the array engine — fleet scale is what it exists for.

    Under a ``faults`` plan with crashes, requeued work from a dead
    pool's workers re-routes deterministically to live siblings (across
    pool boundaries), so a dead pool drains instead of stranding its
    queue (DESIGN.md §11).  Under a ``residency`` plan,
    ``intra="residency"`` places requests on replicas already holding
    their model's weights (DESIGN.md §13)."""
    return run_event_loop(
        requests,
        list(workers),
        policy=hierarchical_policy(
            len(workers), n_pools, inter=inter, intra=intra, seed=seed
        ),
        seed=seed,
        engine=engine,
        horizon=horizon,
        faults=faults,
        residency=residency,
        wall_budget_s=wall_budget_s,
    )


def simulate_cluster(
    requests: Sequence[Request],
    schedulers: Sequence,
    executor: Executor,
    policy: str | Callable = "least_loaded",
    seed: int = 0,
    horizon: float | None = None,
    charge_scheduler_overhead: bool = False,
    faults: "FaultPlan | None" = None,
) -> SimResult:
    """Drive N replica schedulers (sharing ``executor``) against one
    arrival stream."""
    return run_event_loop(
        requests,
        [Worker(s, executor) for s in schedulers],
        policy=policy,
        seed=seed,
        horizon=horizon,
        charge_scheduler_overhead=charge_scheduler_overhead,
        faults=faults,
    )
