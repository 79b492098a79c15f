"""ORLOJ core: distribution-aware batch scheduling for dynamic DNN serving.

The paper's primary contribution (Yu et al., 2022) as a composable library:

- :mod:`repro.core.distributions` — empirical execution-time distributions,
  max order statistics (Eq. 6/8), the batch latency model (Eq. 3–5).
- :mod:`repro.core.priority` — the time-varying batch-aware priority score
  (Eq. 2) with milestone/overflow handling (§4.4).
- :mod:`repro.core.hull` — the O(log² n) dynamic convex-hull priority queue.
- :mod:`repro.core.scheduler` — Algorithm 1.
- :mod:`repro.core.baselines` — Clockwork/Nexus/Clipper/EDF-style baselines.
- :mod:`repro.core.profiler` — the long-term feedback loop (§3.2).
- :mod:`repro.core.eventloop` — the unified multi-worker discrete-event
  engine (§5 evaluation harness = 1 worker; §3.1 replica pools = N workers).
"""

from .baselines import (
    BASELINES,
    ClipperScheduler,
    ClockworkScheduler,
    EDFScheduler,
    NexusScheduler,
)
from .distributions import (
    BatchLatencyModel,
    EmpiricalDistribution,
    hetero_max,
    iid_max,
    mixture,
    ozbey_max_pdf,
)
from .hull import HullQueue
from .priority import DEFAULT_B, BinScoreModel, Score
from .profiler import OnlineProfiler, ProfilerConfig
from .request import PiecewiseStepCost, Request, StepCost
from .scheduler import (
    Batch,
    MultiModelOrlojScheduler,
    OrlojScheduler,
    SchedulerConfig,
)
from .eventloop import (
    DISPATCH_POLICIES,
    ModelExecutor,
    SchedulerLike,
    SimResult,
    Worker,
    run_event_loop,
    simulate,
)

__all__ = [
    "BatchLatencyModel",
    "EmpiricalDistribution",
    "hetero_max",
    "iid_max",
    "mixture",
    "ozbey_max_pdf",
    "HullQueue",
    "DEFAULT_B",
    "BinScoreModel",
    "Score",
    "OnlineProfiler",
    "ProfilerConfig",
    "PiecewiseStepCost",
    "Request",
    "StepCost",
    "Batch",
    "MultiModelOrlojScheduler",
    "OrlojScheduler",
    "SchedulerConfig",
    "BASELINES",
    "ClipperScheduler",
    "ClockworkScheduler",
    "EDFScheduler",
    "NexusScheduler",
    "DISPATCH_POLICIES",
    "ModelExecutor",
    "SchedulerLike",
    "SimResult",
    "Worker",
    "run_event_loop",
    "simulate",
]
