"""Synthetic execution-time distributions mirroring the paper's §5 cases.

The paper evaluates with (a) real model/dataset pairs whose standalone
execution times it reports as mean/P99 (Table 1), and (b) synthesized
multimodal distributions: bimodal with varying per-peak std (Table 2),
1–8-modal (Table 3, Fig. 8), unequal peaks (Fig. 9), and static (constant)
workloads (Table 4).  This module generates per-application sampler objects
for all of those cases.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "AppWorkload",
    "normal_modes",
    "bimodal",
    "k_modal",
    "unequal_bimodal",
    "static",
    "lognormal_from_mean_p99",
    "zipf_weights",
    "REAL_TASKS",
    "real_task",
]


def zipf_weights(n_models: int, skew: float) -> np.ndarray:
    """Zipf-skewed model popularity: ``w_i ∝ 1/(i+1)^skew``, normalized.

    The multi-model tier's popularity prior (DESIGN.md §13): production
    model fleets are heavily rank-skewed (Clockwork §2), so rank 0 of the
    zoo roster soaks most of the traffic and the tail stays cold — the
    regime where eviction policy actually matters.  ``skew=0`` is uniform.
    """
    if n_models < 1:
        raise ValueError(f"n_models must be >= 1, got {n_models}")
    if skew < 0.0:
        raise ValueError(f"model_skew must be >= 0, got {skew}")
    w = 1.0 / np.arange(1, n_models + 1, dtype=np.float64) ** skew
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class AppWorkload:
    """One application: a sampler over standalone execution times (ms)."""

    app_id: str
    sampler: Callable[[np.random.Generator, int], np.ndarray]
    weight: float = 1.0

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.asarray(self.sampler(rng, n), dtype=np.float64)
        return np.maximum(out, 0.1)  # execution times are positive


def _truncnorm(mu: float, sigma: float):
    def f(rng: np.random.Generator, n: int) -> np.ndarray:
        return np.maximum(rng.normal(mu, sigma, size=n), 0.1)

    return f


def normal_modes(
    mus: Sequence[float], sigmas: Sequence[float], weights: Sequence[float] | None = None
) -> list[AppWorkload]:
    """One app per mode — the paper's 'multiple applications' setting."""
    weights = weights or [1.0] * len(mus)
    return [
        AppWorkload(f"app{i}", _truncnorm(mu, sd), w)
        for i, (mu, sd, w) in enumerate(zip(mus, sigmas, weights))
    ]


# --- Table 2: bimodal with per-peak std -------------------------------------
# Peaks of the *alone* execution time; the short peak is dominated by the
# fixed batch overhead c0 (batching vital), the long peak by data-dependent
# compute (stragglers costly) — the paper's dynamic-DNN regime.  The case id
# std-s scales the base sigma.
_BIMODAL_MUS = (60.0, 200.0)
_BASE_SIGMA = 12.0


def bimodal(std: float | tuple[float, float] = 1.0) -> list[AppWorkload]:
    if isinstance(std, tuple):
        s1, s2 = std
    else:
        s1 = s2 = std
    return normal_modes(_BIMODAL_MUS, (s1 * _BASE_SIGMA, s2 * _BASE_SIGMA))


def unequal_bimodal(more: str = "short", std: float = 1.0) -> list[AppWorkload]:
    """Fig. 9: bimodal with unequal peak weights."""
    w = (0.8, 0.2) if more == "short" else (0.2, 0.8)
    return normal_modes(
        _BIMODAL_MUS, (std * _BASE_SIGMA, std * _BASE_SIGMA), weights=w
    )


# --- Table 3 / Fig. 8: k-modal ----------------------------------------------
def k_modal(k: int, std: float = 1.0, lo: float = 30.0, hi: float = 200.0) -> list[AppWorkload]:
    if k < 1:
        raise ValueError("k >= 1")
    mus = np.linspace(lo, hi, k) if k > 1 else np.array([(lo + hi) / 2])
    return normal_modes(mus, [std * _BASE_SIGMA] * k)


# --- Table 4: static models ---------------------------------------------------
def static(mean: float = 10.0, jitter: float = 0.02) -> list[AppWorkload]:
    """Constant execution time with small hardware jitter (static DNNs)."""
    return [
        AppWorkload("static", lambda rng, n: rng.normal(mean, mean * jitter, size=n))
    ]


# --- Table 1 real tasks -------------------------------------------------------
def lognormal_from_mean_p99(mean: float, p99: float):
    """Fit a lognormal to a (mean, P99) pair.

    mean = exp(mu + s²/2);  p99 = exp(mu + 2.3263 s)
    → solve s from  ln(p99/mean) = 2.3263 s − s²/2.
    """
    z = 2.3263478740408408
    ratio = math.log(max(p99, mean * 1.0001) / mean)
    # s² /2 - z s + ratio = 0 → smallest positive root
    disc = z * z - 2.0 * ratio
    s = z - math.sqrt(max(disc, 0.0))
    if disc < 0:  # extremely heavy tail: cap
        s = z
    mu = math.log(mean) - s * s / 2.0

    def f(rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.lognormal(mu, s, size=n)

    return f


# (model, dataset) -> (mean ms, p99 ms) from Table 1.
REAL_TASKS: dict[str, tuple[float, float]] = {
    "rdinet-cifar": (683.15, 2667.54),
    "skipnet-imagenet": (3.24, 5.56),
    "blenderbot-convai": (200.39, 242.27),
    "blenderbot-cornell": (203.22, 247.04),
    "gpt-convai": (79.47, 143.40),
    "gpt-cornell": (94.84, 161.69),
    "bart-cnn": (774.66, 1101.99),
    "t5-cnn": (552.91, 797.28),
    "fsmt-wmt": (189.30, 319.31),
    "mbart-wmt": (432.38, 729.87),
}


def real_task(name: str) -> list[AppWorkload]:
    """§5.2 methodology: group the dataset into short- and long-running
    requests and mix them — two apps whose lognormals bracket the published
    (mean, P99)."""
    mean, p99 = REAL_TASKS[name]
    # Split: short group at 0.6×mean, long group chosen to keep the overall
    # mean and stretch the tail to P99.
    short_mean = 0.6 * mean
    long_mean = 1.4 * mean
    return [
        AppWorkload("short", lognormal_from_mean_p99(short_mean, 0.75 * p99), 0.5),
        AppWorkload("long", lognormal_from_mean_p99(long_mean, p99), 0.5),
    ]
