"""Arrival traces and request-set generation (paper §5.2).

The paper adapts the Microsoft Azure Functions (MAF) trace, scaled so the
incoming rate matches the system load, and replays the same generated
request set across systems for fairness.  We synthesize an MAF-like rate
process (bursty, heavy-tailed per-minute rates with diurnal-ish modulation)
and generate Poisson arrivals within each minute bucket, then scale the
rate so the offered load hits a target utilisation.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.distributions import BatchLatencyModel, EmpiricalDistribution
from ..core.request import Request
from .residency import latency_scales, model_roster
from .workload import AppWorkload, zipf_weights

__all__ = [
    "TraceConfig",
    "azure_like_arrivals",
    "generate_requests",
    "generate_token_requests",
    "offered_rate",
    "sample_alone_times",
    "RequestSet",
]


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_requests: int = 2_000
    utilization: float = 0.8  # offered load vs single-worker capacity
    reference_batch: int = 8  # batch size assumed when computing capacity
    burstiness: float = 0.35  # CV of the per-bucket rate process
    bucket_ms: float = 2_000.0  # rate-modulation bucket
    seed: int = 0
    # Arrival-timestamp quantization (a front-end draining its network
    # queue every tick delivers same-instant bursts): arrivals snap to
    # ``floor(t / tick_ms) * tick_ms``.  0 (default) keeps the raw Poisson
    # timestamps — existing grids are bit-identical.  Quantized traces are
    # what the array engine's coalesced bulk paths feed on; the fleet-scale
    # ``cluster`` grids use it.
    tick_ms: float = 0.0
    # Multi-model serving (DESIGN.md §13): requests target one of
    # ``n_models`` zoo architectures with Zipf(``model_skew``) popularity.
    # 1 (default) keeps the tier fully inert — no model ids are assigned,
    # no extra rng stream is consumed, and existing traces stay
    # bit-identical (the ``single-model-noop`` claim gates this).
    n_models: int = 1
    model_skew: float = 1.1


# Dedicated entropy key for the model-assignment stream: model ids are
# drawn from ``SeedSequence([seed, _MODEL_STREAM])``, never from the
# arrival/alone-time generator, so turning multi-model on cannot perturb
# the base trace (and n_models=1 consumes nothing at all).
_MODEL_STREAM = 0x6D6F646C  # "modl"


def azure_like_arrivals(
    rate_per_ms: float, n: int, cfg: TraceConfig, rng: np.random.Generator
) -> np.ndarray:
    """Arrival times (ms) for ``n`` requests at average ``rate_per_ms``.

    Per-bucket rates are Gamma-distributed around the mean (CV =
    ``burstiness``), mimicking MAF burstiness; arrivals are Poisson within a
    bucket.
    """
    cv = max(cfg.burstiness, 1e-3)
    shape = 1.0 / (cv * cv)
    arrivals: list[float] = []
    t = 0.0
    while len(arrivals) < n:
        lam = rate_per_ms * rng.gamma(shape, cv * cv)
        k = rng.poisson(lam * cfg.bucket_ms)
        if k > 0:
            ts = np.sort(rng.uniform(t, t + cfg.bucket_ms, size=k))
            arrivals.extend(ts.tolist())
        t += cfg.bucket_ms
    return np.asarray(arrivals[:n])


def sample_alone_times(
    apps: Sequence[AppWorkload], rng: np.random.Generator, n: int
) -> tuple[np.ndarray, np.ndarray]:
    """Draw ``(app index, alone time)`` for ``n`` requests — the §5.2
    weight-proportional per-app sampling, shared by the sim and engine
    request generators so both substrates draw from identical mixtures."""
    weights = np.array([a.weight for a in apps], dtype=np.float64)
    weights = weights / weights.sum()
    which = rng.choice(len(apps), size=n, p=weights)
    alone = np.empty(n)
    for i, app in enumerate(apps):
        mask = which == i
        if mask.any():
            alone[mask] = app.sample(rng, int(mask.sum()))
    return which, alone


def offered_rate(
    sizes: np.ndarray,
    latency_model: BatchLatencyModel,
    utilization: float,
    reference_batch: int,
    rng: np.random.Generator,
) -> float:
    """Arrival rate (requests/ms) that offers ``utilization`` of one
    worker batching at ``reference_batch``, with the straggler inflation
    of Eq. 4 (E[max] over the joint size mixture).  ``utilization`` is
    load a *well-batched* worker can sustain — which mis-estimating
    schedulers squander (§2.3).  Shared by the sim and engine request
    generators so "utilization 0.85" means the same thing relative to
    either substrate's latency curve."""
    ref_b = reference_batch
    est_max = float(
        np.mean(
            np.max(rng.choice(sizes, size=(256, ref_b), replace=True), axis=1)
        )
    )
    batch_ms = latency_model.c0 + latency_model.c1 * ref_b * est_max
    return utilization * (ref_b / batch_ms)


@dataclasses.dataclass
class RequestSet:
    """A replayable request set (same arrivals/inputs across systems)."""

    requests: list[Request]
    p99_alone: float
    app_history: dict[str, np.ndarray]  # warm-up samples per app

    def fresh(self) -> list[Request]:
        """Clone with reset bookkeeping so each system sees identical input."""
        return [
            Request(
                app_id=r.app_id,
                release=r.release,
                slo=r.slo,
                true_time=r.true_time,
                cost=r.cost,
                extra_deadlines=r.extra_deadlines,
                payload=r.payload,
                model_id=r.model_id,
                prompt_tokens=r.prompt_tokens,
                out_tokens=r.out_tokens,
            )
            for r in self.requests
        ]

    def initial_dists(self, n_bins: int = 12) -> dict[str, EmpiricalDistribution]:
        return {
            app: EmpiricalDistribution.from_samples(xs, n_bins=n_bins)
            for app, xs in self.app_history.items()
        }

    def warm_samples(self) -> np.ndarray:
        """All warm-up alone-times pooled — the ``init_samples`` the point-
        estimator baselines are seeded with (the same historical data ORLOJ
        gets as ``initial_dists``, §5.2 fairness)."""
        return np.concatenate(list(self.app_history.values()))

    def fingerprint(self) -> tuple:
        """Bitwise-stable identity of the generated set (not of any run's
        bookkeeping): same ``(apps, latency model, slo_scale, TraceConfig)``
        must reproduce this exactly — the §5.2 same-request-set fairness
        premise, enforced by the replay-fairness regression test."""
        per_req = tuple(
            (
                r.app_id,
                r.release,
                r.slo,
                r.true_time,
                r.cost,
                r.extra_deadlines,
                r.model_id,
                r.prompt_tokens,
                r.out_tokens,
            )
            for r in self.requests
        )
        history = tuple(
            (app, self.app_history[app].tobytes())
            for app in sorted(self.app_history)
        )
        return (per_req, self.p99_alone, history)


def generate_requests(
    apps: Sequence[AppWorkload],
    latency_model: BatchLatencyModel,
    slo_scale: float = 3.0,
    cfg: TraceConfig | None = None,
    history_per_app: int = 512,
) -> RequestSet:
    """Generate a request set per the §5.2 methodology.

    Workloads are specified in terms of *standalone (alone) execution time*
    ``a`` — what Table 1 reports.  Under the batch latency model (Eq. 3)
    ``alone = c0 + c1·s`` where ``s`` is the request's intrinsic execution
    size; we invert the profiled curve to recover ``s`` (this is exactly
    what a profiler fitting Eq. 3 does).  ``Request.true_time`` carries
    ``s``; the executor computes ``l_B = c0 + c1·k·max(s)``.

    - SLO = ``slo_scale`` × P99 of the *alone* times of the set (§5.2);
    - arrival rate scaled so offered load ≈ ``utilization`` of one worker
      batching at ``reference_batch``.
    """
    cfg = cfg or TraceConfig()
    rng = np.random.default_rng(cfg.seed)
    which, alone = sample_alone_times(apps, rng, cfg.n_requests)

    # Invert Eq. 3 at k = 1: s = (alone − c0) / c1.
    sizes = np.maximum(alone - latency_model.c0, 0.1) / latency_model.c1

    p99 = float(np.quantile(alone, 0.99))
    slo = slo_scale * p99

    rate = offered_rate(
        sizes, latency_model, cfg.utilization, cfg.reference_batch, rng
    )
    arrivals = azure_like_arrivals(rate, cfg.n_requests, cfg, rng)
    if cfg.tick_ms > 0.0:
        arrivals = np.floor(arrivals / cfg.tick_ms) * cfg.tick_ms

    reqs = [
        Request(
            app_id=apps[w].app_id,
            release=float(at),
            slo=slo,
            true_time=float(s),
        )
        for w, at, s in zip(which, arrivals, sizes)
    ]
    history = {
        a.app_id: np.maximum(
            a.sample(rng, history_per_app) - latency_model.c0, 0.1
        )
        / latency_model.c1
        for a in apps
    }
    if cfg.n_models > 1:
        _assign_models(reqs, cfg)
    return RequestSet(requests=reqs, p99_alone=p99, app_history=history)


def _assign_models(reqs: list[Request], cfg: TraceConfig) -> None:
    """Stamp Zipf-popular model ids and per-model execution scaling.

    Draws come from the dedicated ``_MODEL_STREAM`` generator, so the base
    trace (apps, arrivals, alone times, SLOs) is byte-for-byte the one a
    single-model run of the same seed sees; only ``model_id`` and the
    per-model ``true_time`` multiplier differ.  SLOs stay anchored to the
    *unscaled* alone-time p99 — slower models get proportionally tighter
    deadlines, which is exactly the pressure the multi-model grid studies.
    """
    roster = model_roster(cfg.n_models)
    scales = latency_scales(cfg.n_models)
    probs = zipf_weights(cfg.n_models, cfg.model_skew)
    mrng = np.random.default_rng(np.random.SeedSequence([cfg.seed, _MODEL_STREAM]))
    which = mrng.choice(cfg.n_models, size=len(reqs), p=probs)
    for r, m in zip(reqs, which.tolist()):
        r.model_id = roster[m]
        r.true_time *= scales[m]


def generate_token_requests(
    apps: Sequence[AppWorkload],
    *,
    d0: float,
    d1: float,
    prefill_per_token: float,
    ttft_slo_ms: float,
    tpot_slo_ms: float,
    prompt_lo: int = 16,
    prompt_hi: int = 128,
    cfg: TraceConfig | None = None,
    history_per_app: int = 512,
) -> RequestSet:
    """Generate a token-mode request set (DESIGN.md §12).

    The apps' samplers draw *output lengths in tokens* (the ``tokens``
    family in :mod:`repro.eval.workloads`), the hidden data-dependent
    quantity of autoregressive decode.  Each request's SLO is the implied
    TTFT/TPOT deadline ``ttft + tpot·(out_tokens − 1)`` — derived from the
    hidden length, so token schedulers never read it (§3.1 partial-
    information constraint carried over).  ``app_history`` holds warm-up
    *length* samples, the token-mode analogue of the alone-time history
    (``RequestSet.initial_dists`` then yields per-app length
    distributions for the length-aware scheduler, §5.2 fairness).

    Arrival rate: a worker continuously batching at ``reference_batch`` k
    serves k tokens per ``d0 + d1·k`` ms step, so its request throughput
    is ``k / ((d0 + d1·k) · E[out])``; ``utilization`` scales that.
    """
    cfg = cfg or TraceConfig()
    if cfg.n_models > 1:
        raise ValueError(
            "token-mode traces do not support multi-model serving "
            "(decode batches cannot be residency-managed; DESIGN.md §13)"
        )
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_requests
    which, lens = sample_alone_times(apps, rng, n)
    out = np.maximum(np.rint(lens), 1.0)
    prompts = rng.integers(prompt_lo, prompt_hi + 1, size=n)
    # Alone time = own prefill + solo decode; p99 of it anchors reporting
    # (token-mode SLOs come from TTFT/TPOT, not from slo_scale × p99).
    alone = prefill_per_token * prompts + (d0 + d1) * out
    p99 = float(np.quantile(alone, 0.99))

    k = cfg.reference_batch
    rate = cfg.utilization * k / ((d0 + d1 * k) * float(out.mean()))
    arrivals = azure_like_arrivals(rate, n, cfg, rng)
    if cfg.tick_ms > 0.0:
        arrivals = np.floor(arrivals / cfg.tick_ms) * cfg.tick_ms

    reqs = [
        Request(
            app_id=apps[w].app_id,
            release=float(at),
            slo=ttft_slo_ms + tpot_slo_ms * (o - 1.0),
            true_time=float(al),
            prompt_tokens=int(p),
            out_tokens=int(o),
        )
        for w, at, o, p, al in zip(which, arrivals, out, prompts, alone)
    ]
    history = {
        a.app_id: np.maximum(np.rint(a.sample(rng, history_per_app)), 1.0)
        for a in apps
    }
    return RequestSet(requests=reqs, p99_alone=p99, app_history=history)
