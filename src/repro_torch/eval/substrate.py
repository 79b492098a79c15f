"""Engine substrate of the port: run an :class:`~repro_torch.eval.spec.ExperimentSpec`
against the real PyTorch serving engine on the card instead of the Eq.-3
simulator.

This module is the bridge between the two halves of the port: the
scheduling/eval stack (``repro_torch.core``, ``repro_torch.eval``, copies
of the reference's) and the PyTorch model stack (``repro_torch.models``,
``repro_torch.serving.engine``).  A spec with ``substrate="engine"`` (or
``"engine:<model>"``) runs the *same* grid-cell lifecycle as a sim cell —
seeded request set, unified event loop, one
:class:`~repro_torch.eval.spec.ExperimentResult` — except that every batch
is a real forward pass (prefill attention on the flash-attention kernel)
and the virtual clock advances by the *measured* wall-clock of that pass
(DESIGN.md §8).

It differs from the reference's ``repro.eval.substrate`` only where it
builds the engine: :func:`_get_engine` builds a
:class:`~repro_torch.serving.engine.TorchServingEngine` on the device
that :func:`set_engine_device` chose (the card unless a caller asks for
the CPU), and the engine cache is keyed by (model, device).  The
registry, the request mapping, the sim twin and the drift report are the
reference's, line for line.

Sim↔engine mapping
------------------
Workload families are specified as *alone-time* distributions in ms at the
paper's reference constants (``c0=25, c1=1``).  On a padded-batch backend a
request's intrinsic size is its padded token count, so the mapping
rescales each family's alone-times onto the engine's bucket grid:

1. a fixed-seed calibration pass samples the family and anchors its
   ~P99.5 alone-time at the largest sequence bucket (a shape-preserving
   multiplicative rescale; consequently the Fig.-14 ``time_scale`` knob
   would be cancelled bit-for-bit by the calibration and is *rejected* on
   this substrate — real execution times cannot be shrunk);
2. each request's scaled length is snapped to its sequence bucket — the
   shape the hardware actually runs — and ``true_time`` carries that
   bucketed token count, so Eq. 3 with the engine's *profiled* ``(c0,
   c1)`` predicts measured batch latency;
3. SLOs and arrival rates are then derived exactly as in
   :func:`~repro_torch.serving.trace.generate_requests`, but from the profiled
   latency curve, so "utilization 0.85" means the same thing relative to
   the real hardware as it does relative to the simulated worker.

Requests are bit-for-bit reproducible given the spec seed *and* the
profiled constants (cached per process); measured durations are not —
engine outcomes are real measurements.  Each engine cell also replays the
identical request set against an Eq.-3 *sim twin* (same k-padding, same
bucketing, predicted time instead of measured), and the per-cell drift
between the two is reported in ``substrate_meta`` and aggregated into the
``engine_drift`` section of ``BENCH_eval.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np

from ..core.eventloop import run_event_loop
from ..core.request import Request
from ..serving.batcher import bucket_for, padded_batch_size
from ..serving.trace import (
    RequestSet,
    TraceConfig,
    azure_like_arrivals,
    offered_rate,
    sample_alone_times,
)
from .spec import ExperimentResult, ExperimentSpec
from .workloads import build_workload

if TYPE_CHECKING:  # pragma: no cover - typing only, keeps torch out of import
    from ..core.distributions import BatchLatencyModel
    from ..core.eventloop import Worker
    from ..serving.engine import TorchServingEngine

__all__ = [
    "DEFAULT_ENGINE_MODEL",
    "ENGINE_MODELS",
    "EngineModelSpec",
    "build_engine_request_set",
    "drift_report",
    "engine_available",
    "parse_substrate",
    "run_engine_spec",
    "set_engine_device",
]


# ---------------------------------------------------------------- registry


@dataclasses.dataclass(frozen=True)
class EngineModelSpec:
    """One servable model the engine substrate can instantiate.

    ``arch`` names a module in ``repro_torch.configs``; ``toy`` serves its
    ``reduced()`` smoke variant (CPU-runnable) with ``config_overrides``
    applied on top.  ``buckets``/``batch_sizes`` default to the config
    module's ``SERVE_BUCKETS``/``SERVE_BATCH_SIZES`` when ``None``."""

    arch: str
    toy: bool = True
    config_overrides: tuple[tuple[str, object], ...] = ()
    buckets: tuple[int, ...] | None = None
    batch_sizes: tuple[int, ...] | None = None
    profile_reps: int = 2
    init_seed: int = 0


DEFAULT_ENGINE_MODEL = "orloj_gpt"

# name -> servable profile.  ``orloj_gpt`` is the paper's GPT-class example
# model at toy sizes (the engine-smoke grid's workhorse); ``orloj_gpt_paper``
# is the full ~100M configuration for opt-in paper-scale engine runs.
ENGINE_MODELS: dict[str, EngineModelSpec] = {
    "orloj_gpt": EngineModelSpec(
        arch="orloj_gpt",
        toy=True,
        config_overrides=(
            ("d_model", 64),
            ("n_heads", 4),
            ("n_kv_heads", 4),
            ("d_ff", 128),
            ("vocab_size", 256),
        ),
        buckets=(8, 16, 24, 32),
        batch_sizes=(1, 2, 4),
    ),
    "orloj_gpt_paper": EngineModelSpec(arch="orloj_gpt", toy=False),
}


def parse_substrate(substrate: str) -> tuple[str, str]:
    """``"sim"`` → ``("sim", "")``; ``"engine"``/``"engine:<model>"`` →
    ``("engine", model)``.  Raises ``ValueError`` on anything else."""
    if substrate == "sim":
        return "sim", ""
    kind, _, model = substrate.partition(":")
    model = model or DEFAULT_ENGINE_MODEL
    if kind != "engine":
        raise ValueError(
            f"unknown substrate {substrate!r}; expected 'sim', 'engine' or "
            f"'engine:<model>'"
        )
    if model not in ENGINE_MODELS:
        raise ValueError(
            f"unknown engine model {model!r}; known: {sorted(ENGINE_MODELS)}"
        )
    return kind, model


# ----------------------------------------------------------- availability


def _engine_import_error() -> str | None:
    """Why the PyTorch model stack cannot be imported, or ``None`` if it can.
    Kept as a hook point: tests monkeypatch this to simulate a bare env."""
    try:
        importlib.import_module("torch")
    except Exception as e:  # pragma: no cover - depends on environment
        return f"{type(e).__name__}: {e}"
    return None


def engine_available() -> bool:
    """True iff ``substrate="engine"`` cells can run in this environment."""
    return _engine_import_error() is None


# The device every engine cell runs on: the card unless a caller asks for
# the CPU.  The copied grid runner calls ``run_engine_spec(spec)`` with no
# device, so it is held here, in one place (the CLI's ``--device`` and the
# tests set it).
_ENGINE_DEVICE = "cuda"


def set_engine_device(device: str) -> None:
    """Serve every later engine cell on ``device`` (``"cuda"`` or ``"cpu"``)."""
    global _ENGINE_DEVICE
    if device not in ("cuda", "cpu"):
        raise ValueError(f"engine device must be 'cuda' or 'cpu', got {device!r}")
    _ENGINE_DEVICE = device


# Engines are expensive to build (model init + per-shape warm-up +
# latency-curve profiling), so one per (registry model, device) is cached
# per process and shared across cells.
_ENGINE_CACHE: dict[tuple[str, str], tuple["TorchServingEngine", "BatchLatencyModel"]] = {}


def _get_engine(model: str) -> tuple["TorchServingEngine", "BatchLatencyModel"]:
    key = (model, _ENGINE_DEVICE)
    if key in _ENGINE_CACHE:
        return _ENGINE_CACHE[key]
    err = _engine_import_error()
    if err is not None:
        raise RuntimeError(
            f"substrate 'engine' needs the PyTorch model stack, which failed to "
            f"import ({err}); install the 'torch' dependency or run the cell "
            f"with substrate='sim'"
        )
    from ..serving.engine import EngineConfig, TorchServingEngine  # imports torch

    entry = ENGINE_MODELS[model]
    mod = importlib.import_module(f"..configs.{entry.arch}", __package__)
    cfg = mod.CONFIG.reduced(**dict(entry.config_overrides)) if entry.toy else mod.CONFIG
    # Without a card, device "cuda" raises here (device.resolve_device):
    # nothing falls back to the CPU.
    engine = TorchServingEngine(
        cfg,
        EngineConfig(
            buckets=entry.buckets or mod.SERVE_BUCKETS,
            batch_sizes=entry.batch_sizes or mod.SERVE_BATCH_SIZES,
            profile_reps=entry.profile_reps,
        ),
        seed=entry.init_seed,
        device=_ENGINE_DEVICE,
    )
    lm = engine.profile_latency_model()
    _ENGINE_CACHE[key] = (engine, lm)
    return engine, lm


# -------------------------------------------------------- request mapping

# The alone-time→token calibration must not drift with the trace seed (two
# seeds of one cell must measure the same workload), hence its own fixed
# seed; payload token values get an offset stream so they never correlate
# with the trace draws.
_CALIBRATION_SEED = 0x5EED_CAB
_PAYLOAD_SEED_OFFSET = 7_654_321
_CALIBRATION_SAMPLES = 512
_HISTORY_PER_APP = 256


def _snap_lengths(
    alone_ms: np.ndarray, tokens_per_ms: float, buckets: tuple[int, ...]
) -> tuple[np.ndarray, np.ndarray]:
    """Map alone-times to (payload lengths, bucketed sizes) on the grid."""
    lengths = np.clip(
        np.rint(alone_ms * tokens_per_ms), 1, buckets[-1]
    ).astype(np.int64)
    sizes = np.array([bucket_for(int(n), buckets) for n in lengths], np.float64)
    return lengths, sizes


def build_engine_request_set(
    spec: ExperimentSpec,
    buckets: tuple[int, ...],
    batch_sizes: tuple[int, ...],
    lm: "BatchLatencyModel",
    vocab_size: int,
) -> RequestSet:
    """The engine-side analogue of :func:`~repro.serving.trace
    .generate_requests`: same §5.2 methodology (per-app sampling, SLO =
    ``slo_scale``×P99-alone, MAF-like arrivals at a capacity-relative
    rate), except that sizes are token counts snapped to the engine's
    sequence buckets and every request carries a real token payload.

    Deterministic given ``(spec, buckets, batch_sizes, lm)``; the profiled
    ``lm`` only affects alone-times/SLO/arrival pacing, never which token
    lengths are drawn."""
    apps = build_workload(spec.workload, spec.workload_params, spec.time_scale)

    # 1. calibration: anchor the family's ~P99.5 alone-time at the largest
    # bucket (shape-preserving rescale into the representable range).
    crng = np.random.default_rng(_CALIBRATION_SEED)
    calib = np.concatenate([a.sample(crng, _CALIBRATION_SAMPLES) for a in apps])
    ref = float(np.quantile(calib, 0.995))
    tokens_per_ms = buckets[-1] / max(ref, 1e-9)

    # 2. the seeded trace draw (shared §5.2 sampling with generate_requests).
    rng = np.random.default_rng(spec.seed)
    n = spec.n_requests
    which, alone_ms = sample_alone_times(apps, rng, n)
    lengths, sizes = _snap_lengths(alone_ms, tokens_per_ms, buckets)

    alone = lm.c0 + lm.c1 * sizes
    p99 = float(np.quantile(alone, 0.99))
    slo = spec.slo_scale * p99

    # 3. arrival pacing relative to the *profiled* capacity (Eq. 4 E[max]
    # straggler inflation at the largest supported batch).
    rate = offered_rate(sizes, lm, spec.utilization, batch_sizes[-1], rng)
    cfg = TraceConfig(
        n_requests=n, utilization=spec.utilization, seed=spec.seed
    )
    arrivals = azure_like_arrivals(rate, n, cfg, rng)

    prng = np.random.default_rng(spec.seed + _PAYLOAD_SEED_OFFSET)
    reqs = [
        Request(
            app_id=apps[w].app_id,
            release=float(at),
            slo=slo,
            true_time=float(s),
            payload=prng.integers(1, vocab_size, size=int(L)).astype(np.int32),
        )
        for w, at, s, L in zip(which, arrivals, sizes, lengths)
    ]
    history = {}
    for app in apps:
        _, szs = _snap_lengths(
            app.sample(rng, _HISTORY_PER_APP), tokens_per_ms, buckets
        )
        history[app.app_id] = szs
    return RequestSet(requests=reqs, p99_alone=p99, app_history=history)


# ------------------------------------------------------------- execution


@dataclasses.dataclass
class _PredictedExecutor:
    """Eq.-3 twin of :class:`~repro.serving.engine.JaxExecutor`: identical
    k-padding and sequence bucketing, predicted time instead of measured.
    The drift between a cell served by this and by the real executor is
    pure modelling error + hardware noise — the quantity ``engine_drift``
    reports."""

    lm: "BatchLatencyModel"
    buckets: tuple[int, ...]
    batch_sizes: tuple[int, ...]

    def __call__(self, batch, now: float) -> float:
        k = padded_batch_size(len(batch.requests), self.batch_sizes)
        size = bucket_for(
            int(math.ceil(max(r.true_time for r in batch.requests))), self.buckets
        )
        return self.lm.c0 + self.lm.c1 * k * size


def _pool(
    spec: ExperimentSpec,
    lm: "BatchLatencyModel",
    rs: RequestSet,
    engine: "TorchServingEngine",
    batch_sizes: tuple[int, ...],
    *,
    predicted: bool,
) -> "list[Worker]":
    """Build the worker pool for one engine cell (or its sim twin) — same
    shared pool builder as the sim substrate, with the executor swapped."""
    from .runner import _build_pool

    if predicted:
        ex_for = lambda i, wlm, slow: _PredictedExecutor(  # noqa: E731
            wlm, engine.cfg.buckets, batch_sizes
        )
    else:
        ex_for = lambda i, wlm, slow: engine.executor_for(  # noqa: E731
            2.0 if slow else 1.0
        )
    return _build_pool(spec, lm, rs, ex_for, batch_sizes=batch_sizes)


def run_engine_spec(spec: ExperimentSpec) -> ExperimentResult:
    """Run one ``substrate="engine"`` cell and fold the measured replay
    into the standard :class:`ExperimentResult` schema (so the claims
    layer consumes it unmodified)."""
    t_wall = time.perf_counter()  # simlint: ignore[R1] -- wall_time_s metadata column; engine cells measure real hardware by design
    kind, model = parse_substrate(spec.substrate)
    if kind != "engine":
        raise ValueError(f"run_engine_spec got a {kind!r} spec: {spec}")
    if spec.time_scale != 1.0:
        # The Fig.-14 shrink knob is sim-only: the engine's execution
        # times are real, and the calibration rescale would cancel a
        # scaled workload back out bit-for-bit — a silent no-op is worse
        # than an error.
        raise ValueError(
            f"time_scale={spec.time_scale:g} is not supported on the engine "
            f"substrate (execution times are measured, not modelled); run "
            f"the shrink sweep with substrate='sim'"
        )
    engine, lm = _get_engine(model)
    batch_sizes = engine.cfg.batch_sizes
    rs = build_engine_request_set(
        spec, engine.cfg.buckets, batch_sizes, lm, engine.model.cfg.vocab_size
    )
    loop_seed = spec.seed if spec.loop_seed is None else spec.loop_seed

    engine.executor.drain_measured()
    served = rs.fresh()
    # The real replay goes through the engine's own pool entry point; the
    # per-replica executors come from its factory (scaled-slow for the
    # hetero back half).
    workers = _pool(spec, lm, rs, engine, batch_sizes, predicted=False)
    res = engine.serve_pool(
        served,
        [w.scheduler for w in workers],
        policy=spec.policy,
        seed=loop_seed,
        charge_scheduler_overhead=spec.charge_overhead,
        executors=[w.executor for w in workers],
    )
    measured = engine.executor.drain_measured()

    # Per-batch predicted-vs-measured drift of the executed shapes (MAPE
    # convention: error relative to the *measured* value).
    err = np.array(
        [abs(ms - (lm.c0 + lm.c1 * k * b)) for k, b, ms in measured]
    )
    meas = np.array([ms for _, _, ms in measured])

    # Sim twin: the identical request set under the Eq.-3 executor, with
    # every knob (including overhead charging) matching the real run so
    # the drift is modelling error + hardware noise, nothing else.
    twin = run_event_loop(
        rs.fresh(),
        _pool(spec, lm, rs, engine, batch_sizes, predicted=True),
        policy=spec.policy,
        charge_scheduler_overhead=spec.charge_overhead,
        seed=loop_seed,
    )

    meta = {
        "model": model,
        "model_name": engine.model.cfg.name,
        "c0_ms": lm.c0,
        "c1_ms_per_token": lm.c1,
        "buckets": list(engine.cfg.buckets),
        "batch_sizes": list(batch_sizes),
        "n_batches": res.n_batches,
        # The executor's measured log is a bounded ring; if a paper-scale
        # cell overflows it, the drift stats cover only the most recent
        # MEASURED_LOG_CAP batches — flagged so the artifact never claims
        # more coverage than it has.
        "batch_log_truncated": len(measured) < res.n_batches,
        "batch_abs_err_p50_ms": float(np.median(err)) if len(err) else 0.0,
        "batch_mape": float(np.mean(err / meas)) if len(err) else 0.0,
        # Finish set by request *index* in generation order (rids are a
        # process-global counter and not stable across runs).
        "finish_idx": [i for i, r in enumerate(served) if r.ok],
        "sim_twin": {
            "finish_rate": twin.finish_rate,
            "n_finished_ok": twin.n_finished_ok,
            "n_dropped": twin.n_dropped,
            "latency_p50_ms": float(np.quantile(twin.latencies, 0.5))
            if len(twin.latencies)
            else 0.0,
        },
        "finish_rate_drift": res.finish_rate - twin.finish_rate,
    }
    from .runner import _fold_result

    return _fold_result(
        # simlint: ignore[R1] -- wall_time_s metadata column; engine cells measure real hardware by design
        spec, rs, res, time.perf_counter() - t_wall, substrate_meta=meta
    )


def drift_report(results: Sequence[ExperimentResult]) -> dict | None:
    """Aggregate the per-cell sim-vs-engine drift of a result set into the
    ``engine_drift`` artifact section; ``None`` when there are no engine
    cells."""
    cells = []
    for r in results:
        m = r.substrate_meta
        if r.spec.substrate == "sim" or "sim_twin" not in m:
            continue
        cells.append(
            {
                "tag": r.spec.tag,
                "model": m["model"],
                "finish_rate_engine": r.finish_rate,
                "finish_rate_sim_twin": m["sim_twin"]["finish_rate"],
                "finish_rate_drift": m["finish_rate_drift"],
                "batch_mape": m["batch_mape"],
                "n_batches": m["n_batches"],
            }
        )
    if not cells:
        return None
    drifts = np.array([abs(c["finish_rate_drift"]) for c in cells])
    mapes = np.array([c["batch_mape"] for c in cells])
    return {
        "n_cells": len(cells),
        "mean_abs_finish_rate_drift": float(drifts.mean()),
        "max_abs_finish_rate_drift": float(drifts.max()),
        "mean_batch_mape": float(mapes.mean()),
        "cells": cells,
    }
