"""Online per-application execution-time profiler (paper §3.2).

The long-term feedback loop: finished requests are *sampled* and evaluated
standalone off the critical path; their alone-times are accumulated per
application and periodically picked up by the scheduler.  To adapt to input
drift the profiling memory is reset on a configurable window.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque

import numpy as np

from .distributions import EmpiricalDistribution

__all__ = ["ProfilerConfig", "OnlineProfiler"]


@dataclasses.dataclass(frozen=True)
class ProfilerConfig:
    sample_rate: float = 0.25  # fraction of finished requests re-profiled
    pickup_interval: float = 2_000.0  # ms between scheduler pickups (§3.2)
    memory_window: float = 120_000.0  # ms; drift-reset window (§3.2)
    max_samples_per_app: int = 4_096
    n_bins: int = 12
    seed: int = 0


class OnlineProfiler:
    """Collects sampled alone-times per app; serves snapshot distributions."""

    def __init__(self, cfg: ProfilerConfig | None = None):
        self.cfg = cfg or ProfilerConfig()
        self._rng = np.random.default_rng(self.cfg.seed)
        self._samples: dict[str, deque[tuple[float, float]]] = defaultdict(
            lambda: deque(maxlen=self.cfg.max_samples_per_app)
        )
        self._last_pickup = -np.inf
        self._snapshot: dict[str, EmpiricalDistribution] = {}
        self._dirty = False

    # -- ingestion ----------------------------------------------------------
    def seed_history(
        self, app_id: str, alone_times_ms: Sequence[float], now: float = 0.0
    ) -> None:
        """Warm-start from historical data (the paper assumes SLOs and
        distributions are derived from historical observations)."""
        for x in alone_times_ms:
            self._samples[app_id].append((now, float(x)))
        self._dirty = True

    def observe(self, app_id: str, alone_time_ms: float, now: float) -> None:
        """Called when a finished request is (probabilistically) sampled."""
        if self._rng.random() <= self.cfg.sample_rate:
            self._samples[app_id].append((now, float(alone_time_ms)))
            self._dirty = True

    # -- pickup -------------------------------------------------------------
    def maybe_pickup(self, now: float) -> dict[str, EmpiricalDistribution] | None:
        """Return fresh per-app distributions if the pickup interval elapsed
        and new data arrived; otherwise ``None`` (scheduler keeps its copy)."""
        if now - self._last_pickup < self.cfg.pickup_interval:
            return None
        self._last_pickup = now
        if not self._dirty:
            return None
        self._dirty = False
        self._expire(now)
        snap: dict[str, EmpiricalDistribution] = {}
        for app, buf in self._samples.items():
            if len(buf) >= 2:
                snap[app] = EmpiricalDistribution.from_samples(
                    [x for _, x in buf], n_bins=self.cfg.n_bins
                )
        if snap:
            self._snapshot = snap
            return dict(snap)
        return None

    def current(self) -> dict[str, EmpiricalDistribution]:
        return dict(self._snapshot)

    def _expire(self, now: float) -> None:
        cutoff = now - self.cfg.memory_window
        for buf in self._samples.values():
            while buf and buf[0][0] < cutoff and len(buf) > 8:
                buf.popleft()
