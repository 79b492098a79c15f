"""Per-worker weights residency: the multi-model serving tier's memory model.

Orloj (§3) assumes the model being scheduled is already resident on the
worker.  Clockwork ("Serving DNNs like Clockwork", PAPERS.md) shows the
production regime is many models sharing workers under memory pressure,
where the SLO killer is the *cold start* — PCIe-loading the weights — not
execution variance.  This module prices that regime for the simulator:

- a :class:`ModelProfile` per zoo architecture (``repro.configs``), with
  weight bytes from ``ModelConfig.n_params_estimate`` at bf16 and a load
  time from a PCIe-style transfer model (``bytes / bandwidth + fixed``);
- a frozen :class:`ResidencyPlan` (the :class:`~repro.serving.faults.FaultPlan`
  pattern: validated knobs, ``to_dict``/``from_dict``, ``start()`` factory)
  describing per-worker capacity in bytes and the eviction policy;
- a mutable :class:`ResidencyState` holding each worker's resident set,
  charged by *both* event engines through ``acquire()`` — fully
  deterministic (no rng, virtual time only), so the scalar oracle loop and
  the array engine stay bit-identical under residency (DESIGN.md §13).

Eviction policies:

``lru``
    Evict the least-recently-*used* model (use = dispatch of a batch for
    it on that worker).  The Clockwork default.
``cost_aware``
    Evict the resident model with the smallest *re-load risk*:
    ``load_ms × observed demand share``.  A cheap-to-reload model that is
    rarely requested is evicted before a 2-GiB hot one even if the hot one
    was touched less recently — the "load time × expected demand" policy
    the multi-model tier puts under test.

The plan is only ever built for multi-model cells; single-model runs pass
``residency=None`` to ``run_event_loop`` and take zero new branches (the
``single-model-noop`` claim gates this bitwise).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from ..configs import ARCHS, get_config

__all__ = [
    "DEFAULT_ROSTER",
    "ModelProfile",
    "ResidencyPlan",
    "ResidencyState",
    "latency_scales",
    "model_roster",
    "zoo_profile",
]

# PCIe-style weights transfer: ~16 GiB/s effective host-to-device bandwidth
# plus a fixed per-load cost (allocation, cudaMalloc-style setup).  A 1B-param
# bf16 model (~2.2 GiB) loads in ~140 ms — the same order as the bimodal
# workloads' long peak, so cold starts genuinely compete with execution.
PCIE_BYTES_PER_MS = 16.0 * 2**30 / 1e3
LOAD_FIXED_MS = 5.0
# Freeing device memory is cheap but not free (unmap + allocator bookkeeping).
EVICT_MS = 1.0

# Zoo roster in model-popularity order (Zipf rank 0 = most popular); the
# first four are the ~1–3 GiB architectures, so small-n multi-model cells
# exercise real eviction churn under a few-GiB worker budget without
# needing a 17-GiB (glm4_9b) worker.
DEFAULT_ROSTER = (
    "olmo_1b",
    "internvl2_1b",
    "hymba_1_5b",
    "xlstm_1_3b",
    "glm4_9b",
    "musicgen_large",
    "granite_34b",
    "dbrx_132b",
    "nemotron_4_340b",
    "arctic_480b",
    "orloj_gpt",
)


def model_roster(n_models: int) -> tuple[str, ...]:
    """First ``n_models`` zoo architectures in popularity order."""
    if n_models < 1:
        raise ValueError(f"n_models must be >= 1, got {n_models}")
    if n_models > len(DEFAULT_ROSTER):
        raise ValueError(
            f"n_models={n_models} exceeds the {len(DEFAULT_ROSTER)}-entry "
            f"config-zoo roster"
        )
    return DEFAULT_ROSTER[:n_models]


def latency_scales(n_models: int) -> tuple[float, ...]:
    """Per-model execution-time multiplier (rank ``i`` runs ``1 + i/4``×).

    A deterministic heterogeneity ladder, not a roofline estimate: it keeps
    the per-model latency *distributions* distinct (so the scheduler's
    per-model score models genuinely differ) without coupling the workload
    shape to zoo parameter counts.  DESIGN.md §13 records the choice.
    """
    return tuple(1.0 + 0.25 * i for i in range(n_models))


def zoo_profile(name: str) -> "ModelProfile":
    """Profile a zoo architecture: bf16 weight bytes + PCIe load time."""
    if name not in ARCHS:
        raise ValueError(f"unknown model {name!r}; zoo has {sorted(ARCHS)}")
    nbytes = 2 * get_config(name).n_params_estimate  # bf16
    return ModelProfile(
        model_id=name,
        nbytes=float(nbytes),
        load_ms=nbytes / PCIE_BYTES_PER_MS + LOAD_FIXED_MS,
        evict_ms=EVICT_MS,
    )


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Residency-relevant facts about one model: footprint and swap costs."""

    model_id: str
    nbytes: float
    load_ms: float
    evict_ms: float = EVICT_MS

    def __post_init__(self) -> None:
        if self.nbytes <= 0.0:
            raise ValueError(f"{self.model_id}: nbytes must be > 0")
        if self.load_ms < 0.0 or self.evict_ms < 0.0:
            raise ValueError(f"{self.model_id}: load/evict cost must be >= 0")


_POLICIES = ("lru", "cost_aware")


@dataclasses.dataclass(frozen=True)
class ResidencyPlan:
    """Frozen description of the per-worker weights cache.

    ``worker_mem`` is the device-memory budget in bytes, identical across
    workers; ``profiles`` the models this run can serve.  Built once per
    eval cell (``FaultPlan`` pattern); ``start(n_workers)`` mints the
    mutable per-run state.
    """

    worker_mem: float
    profiles: tuple[ModelProfile, ...]
    policy: str = "lru"

    def __post_init__(self) -> None:
        if self.policy not in _POLICIES:
            raise ValueError(
                f"unknown eviction policy {self.policy!r}; pick from {_POLICIES}"
            )
        if self.worker_mem <= 0.0:
            raise ValueError(f"worker_mem must be > 0 bytes, got {self.worker_mem}")
        if not self.profiles:
            raise ValueError("a residency plan needs at least one model profile")
        ids = [p.model_id for p in self.profiles]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate model ids in profiles: {ids}")
        for p in self.profiles:
            if p.nbytes > self.worker_mem:
                raise ValueError(
                    f"model {p.model_id!r} ({p.nbytes:.3g} B) can never fit "
                    f"in worker_mem={self.worker_mem:.3g} B"
                )

    @classmethod
    def from_zoo(
        cls, model_ids: Sequence[str], worker_mem: float, policy: str = "lru"
    ) -> "ResidencyPlan":
        return cls(
            worker_mem=float(worker_mem),
            profiles=tuple(zoo_profile(m) for m in model_ids),
            policy=policy,
        )

    def to_dict(self) -> dict:
        return {
            "worker_mem": self.worker_mem,
            "policy": self.policy,
            "models": [
                {
                    "model_id": p.model_id,
                    "nbytes": p.nbytes,
                    "load_ms": p.load_ms,
                    "evict_ms": p.evict_ms,
                }
                for p in self.profiles
            ],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ResidencyPlan":
        """Build from a JSON-ish mapping, ignoring unknown keys (forward
        compatibility with richer future artifacts, like FaultPlan)."""
        profiles = tuple(
            ModelProfile(
                model_id=m["model_id"],
                nbytes=float(m["nbytes"]),
                load_ms=float(m["load_ms"]),
                evict_ms=float(m.get("evict_ms", EVICT_MS)),
            )
            for m in d.get("models", ())
        )
        return cls(
            worker_mem=float(d.get("worker_mem", 0.0)),
            profiles=profiles,
            policy=str(d.get("policy", "lru")),
        )

    def start(self, n_workers: int) -> "ResidencyState":
        return ResidencyState(self, n_workers)


class ResidencyState:
    """Mutable per-run residency bookkeeping, shared by both event engines.

    Deterministic by construction: no rng, no wall clock — the resident
    sets evolve purely from the sequence of ``acquire`` calls, which both
    engines issue in the identical dispatch order (the bit-identity
    contract).  ``acquire`` returns the *stall* in virtual ms the dispatch
    must charge before execution can start: 0 on a residency hit, else the
    evict cost of every victim plus the model's load time.
    """

    __slots__ = (
        "plan",
        "_profiles",
        "_resident",  # per worker: {model_id: last-use ms}, insertion = LRU order
        "_mem_used",
        "_demand",  # model_id -> acquires so far (cost_aware demand signal)
        "n_loads",
        "n_evicts",
        "n_hits",
        "load_ms_total",
    )

    def __init__(self, plan: ResidencyPlan, n_workers: int) -> None:
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.plan = plan
        self._profiles = {p.model_id: p for p in plan.profiles}
        self._resident: list[dict[str, float]] = [dict() for _ in range(n_workers)]
        self._mem_used = [0.0] * n_workers
        self._demand = {p.model_id: 0 for p in plan.profiles}
        self.n_loads = 0
        self.n_evicts = 0
        self.n_hits = 0
        self.load_ms_total = 0.0

    def resident(self, w: int, model_id: str) -> bool:
        """Read-only residency probe (dispatch policies use this)."""
        return model_id in self._resident[w]

    def _victim(self, w: int) -> str:
        cache = self._resident[w]
        if self.plan.policy == "lru":
            # dict preserves insertion order and ``acquire`` re-inserts on
            # every touch, so the first key is the least recently used
            return next(iter(cache))
        # cost_aware: evict the smallest re-load risk = load_ms × demand
        # share.  Tie-break on (last use, model id) so the choice is total.
        total = max(sum(self._demand[m] for m in cache), 1)
        return min(
            cache,
            key=lambda m: (
                self._profiles[m].load_ms * self._demand[m] / total,
                cache[m],
                m,
            ),
        )

    def acquire(self, w: int, model_id: str, now: float) -> float:
        """Make ``model_id`` resident on worker ``w``; return the stall ms."""
        prof = self._profiles.get(model_id)
        if prof is None:
            raise ValueError(
                f"model {model_id!r} has no profile in the residency plan "
                f"(plan serves {sorted(self._profiles)})"
            )
        self._demand[model_id] += 1
        cache = self._resident[w]
        if model_id in cache:
            del cache[model_id]  # re-insert: newest position = most recent
            cache[model_id] = now
            self.n_hits += 1
            return 0.0
        stall = 0.0
        while self._mem_used[w] + prof.nbytes > self.plan.worker_mem:
            victim = self._victim(w)
            vprof = self._profiles[victim]
            del cache[victim]
            self._mem_used[w] -= vprof.nbytes
            self.n_evicts += 1
            stall += vprof.evict_ms
        cache[model_id] = now
        self._mem_used[w] += prof.nbytes
        self.n_loads += 1
        stall += prof.load_ms
        self.load_ms_total += stall
        return stall
