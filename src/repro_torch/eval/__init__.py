"""``repro.eval`` — the typed evaluation subsystem (§5 methodology as code).

Promotes the print-CSV benchmarks into a structured pipeline around one
grid-cell lifecycle — spec → seeded RequestSet → result → claim (see
:mod:`repro.eval.spec` for the stage-by-stage contract):

- :mod:`repro.eval.spec` — :class:`ExperimentSpec` (one grid cell: workload
  family, SLO scale, utilization, seed, system, pool shape, substrate) and
  :class:`ExperimentResult`, both JSON round-trippable;
- :mod:`repro.eval.workloads` — JSON-addressable workload families;
- :mod:`repro.eval.grid` — the conformance grids (``tiny``/``small``/
  ``full``/``engine-smoke``) plus spec constructors for every legacy
  benchmark table;
- :mod:`repro.eval.runner` — seeded per-cell replay, process fan-out,
  the ``BENCH_eval.json`` artifact;
- :mod:`repro.eval.substrate` — the real-engine tier: ``substrate="engine"``
  cells served by the actual JAX model with measured batch times, plus the
  sim-vs-engine drift report (DESIGN.md §8);
- :mod:`repro.eval.claims` — the paper-claims conformance gate;
- :mod:`repro.eval.sched_gate` — the ``BENCH_sched.json`` CI ratio check;
- :mod:`repro.eval.run` — ``python -m repro.eval.run --grid small``.
"""

from .claims import (
    MONO_SLACK,
    SCALEOUT_SLACK,
    STATIC_NOISE_BAND,
    TIGHT_SLO_MAX,
    ClaimResult,
    evaluate_claims,
    format_report,
)
from .grid import GRIDS, SYSTEMS
from .runner import (
    DEFAULT_ARTIFACT,
    read_artifact,
    run_spec,
    run_specs,
    write_artifact,
)
from .spec import TIMING_FIELDS, ExperimentResult, ExperimentSpec
from .substrate import ENGINE_MODELS, engine_available, parse_substrate
from .workloads import FAMILIES, build_workload

__all__ = [
    "MONO_SLACK",
    "SCALEOUT_SLACK",
    "STATIC_NOISE_BAND",
    "TIGHT_SLO_MAX",
    "ClaimResult",
    "evaluate_claims",
    "format_report",
    "GRIDS",
    "SYSTEMS",
    "DEFAULT_ARTIFACT",
    "read_artifact",
    "run_spec",
    "run_specs",
    "write_artifact",
    "TIMING_FIELDS",
    "ExperimentResult",
    "ExperimentSpec",
    "ENGINE_MODELS",
    "engine_available",
    "parse_substrate",
    "FAMILIES",
    "build_workload",
]
