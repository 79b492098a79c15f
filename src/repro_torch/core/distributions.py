"""Empirical execution-time distributions and order statistics (paper §4.2).

Orloj represents the standalone execution time of a request as a random
variable described by an empirical histogram learned online.  This module
implements:

- :class:`EmpiricalDistribution` — a histogram with a *piecewise-linear* CDF
  (uniform-within-bin).  The paper notes (§4.2.1) that using the raw discrete
  histogram CDF for ``E[max]`` is "far too inaccurate"; the piecewise-linear
  CDF lets us integrate ``E[max] = lo + ∫ (1 - F(l)^k) dl`` *exactly* per
  segment (the integrand is polynomial on each segment).
- i.i.d. max order statistics (Eq. 6): ``F_(k) = F^k``.
- non-identical max order statistics (Eq. 8, Özbey et al.).  For the
  *maximum*, Eq. 8 reduces to the product form ``F_max = Π_i F_i``; we
  implement the product form (numerically stable, O(k·bins)) and keep a
  literal small-k expansion of Eq. 8 for validation in tests.
- the batch execution-time model (Eq. 3–5):
  ``L_B = c0 + c1 · k · max_r L_r``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import numpy as np

__all__ = [
    "EmpiricalDistribution",
    "iid_max",
    "hetero_max",
    "ozbey_max_pdf",
    "mixture",
    "BatchLatencyModel",
]


@dataclasses.dataclass(frozen=True)
class EmpiricalDistribution:
    """Histogram distribution with a piecewise-linear CDF.

    ``edges``  — monotonically increasing bin edges, length ``n + 1``.
    ``probs``  — bin probabilities, length ``n``; sums to 1.
    """

    edges: np.ndarray
    probs: np.ndarray

    def __post_init__(self) -> None:
        edges = np.asarray(self.edges, dtype=np.float64)
        probs = np.asarray(self.probs, dtype=np.float64)
        if edges.ndim != 1 or probs.ndim != 1 or edges.size != probs.size + 1:
            raise ValueError("edges must have len(probs) + 1 entries")
        if np.any(np.diff(edges) <= 0):
            raise ValueError("edges must be strictly increasing")
        if np.any(probs < -1e-12):
            raise ValueError("probs must be non-negative")
        total = probs.sum()
        if not math.isfinite(total) or total <= 0:
            raise ValueError("probs must sum to a positive finite value")
        object.__setattr__(self, "edges", edges)
        object.__setattr__(self, "probs", np.maximum(probs, 0.0) / total)
        # CDF at the knots, computed once: cdf()/quantile()/iid_max/
        # expected_max/rebin all consume it, and re-running np.cumsum per
        # call dominated the distribution algebra on the hot path.  Frozen
        # so a caller cannot corrupt the cache in place.
        knots = np.concatenate([[0.0], np.cumsum(self.probs)])
        knots.flags.writeable = False
        object.__setattr__(self, "_cdf_knots", knots)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_samples(
        cls, samples: Sequence[float], n_bins: int = 16
    ) -> "EmpiricalDistribution":
        samples = np.asarray(list(samples), dtype=np.float64)
        if samples.size == 0:
            raise ValueError("need at least one sample")
        lo, hi = float(samples.min()), float(samples.max())
        if hi <= lo:  # degenerate: all samples equal
            span = max(abs(lo) * 1e-3, 1e-6)
            lo, hi = lo - span, hi + span
        counts, edges = np.histogram(samples, bins=n_bins, range=(lo, hi))
        return cls(edges, counts.astype(np.float64))

    @classmethod
    def delta(cls, value: float, width: float | None = None) -> "EmpiricalDistribution":
        """A (near-)deterministic execution time — the static-DNN case."""
        width = width if width is not None else max(abs(value) * 1e-3, 1e-6)
        return cls(np.array([value - width / 2, value + width / 2]), np.array([1.0]))

    # -- basic queries -----------------------------------------------------
    @property
    def lo(self) -> float:
        return float(self.edges[0])

    @property
    def hi(self) -> float:
        return float(self.edges[-1])

    def cdf(self, x: np.ndarray | float) -> np.ndarray:
        """Piecewise-linear CDF evaluated at ``x``."""
        x = np.asarray(x, dtype=np.float64)
        return np.interp(x, self.edges, self._cdf_knots, left=0.0, right=1.0)

    def cdf_at_knots(self) -> np.ndarray:
        """Cached CDF at the bin edges (read-only view — do not mutate)."""
        return self._cdf_knots

    def mean(self) -> float:
        mids = 0.5 * (self.edges[:-1] + self.edges[1:])
        return float(np.dot(mids, self.probs))

    def var(self) -> float:
        mids = 0.5 * (self.edges[:-1] + self.edges[1:])
        m = self.mean()
        # within-bin uniform variance + between-bin variance
        w = np.diff(self.edges)
        return float(np.dot(self.probs, (mids - m) ** 2 + w * w / 12.0))

    def quantile(self, q: float) -> float:
        cum = self.cdf_at_knots()
        return float(np.interp(q, cum, self.edges))

    def sample(self, rng: np.random.Generator, size: int = 1) -> np.ndarray:
        idx = rng.choice(self.probs.size, size=size, p=self.probs)
        u = rng.random(size)
        return self.edges[idx] + u * (self.edges[idx + 1] - self.edges[idx])

    # -- transforms ---------------------------------------------------------
    def affine(self, scale: float, shift: float) -> "EmpiricalDistribution":
        """Distribution of ``scale · X + shift`` (scale > 0)."""
        if scale <= 0:
            raise ValueError("scale must be positive")
        return EmpiricalDistribution(self.edges * scale + shift, self.probs)

    def rebin(self, edges: np.ndarray) -> "EmpiricalDistribution":
        """Project this distribution onto a new knot grid."""
        cdf = self.cdf(edges)
        probs = np.diff(cdf)
        # Degenerate overlap can yield all-zero probs if grids are disjoint.
        if probs.sum() <= 0:
            raise ValueError("rebin grid does not overlap distribution support")
        return EmpiricalDistribution(edges, probs)

    def iid_max(self, k: int) -> "EmpiricalDistribution":
        return iid_max(self, k)

    # -- conditional tail (token-mode remaining-length view) ------------------
    def conditional_tail(self, t: float) -> "EmpiricalDistribution":
        """Distribution of ``X | X > t`` — the renormalized upper tail.

        The per-step view token-level scheduling needs (DESIGN.md §12): a
        request that has already produced ``t`` tokens without hitting EOS
        has remaining-length distribution ``(X − t) | X > t``; this returns
        the un-shifted conditional ``X | X > t`` (shift by ``−t`` via the
        caller, or use :meth:`expected_remaining` for the mean directly).
        Exact under the piecewise-linear CDF."""
        edges = self.edges
        if t <= edges[0]:
            return self
        tail = 1.0 - float(self.cdf(t))
        if t >= edges[-1] or tail <= 0.0:
            raise ValueError(f"no mass above t={t} (support ends at {self.hi})")
        i = int(np.searchsorted(edges, t, side="right"))
        new_edges = np.concatenate([[t], edges[i:]])
        cdf = np.interp(new_edges, edges, self._cdf_knots)
        return EmpiricalDistribution(new_edges, np.diff(cdf))

    def expected_remaining(self, t: float) -> float:
        """``E[X − t | X > t]`` — exact under the piecewise-linear CDF.

        ``∫_t^hi (1 − F(x)) dx / (1 − F(t))``; integrand is linear on each
        segment, so the trapezoid over the knots above ``t`` is exact.
        Returns 0 when no mass lies above ``t`` (the tail is exhausted —
        callers treat this as "expected to finish immediately")."""
        edges = self.edges
        if t >= edges[-1]:
            return 0.0
        knots = self._cdf_knots
        st = 1.0 - float(np.interp(t, edges, knots, left=0.0, right=1.0))
        if st <= 1e-12:
            return 0.0
        i = int(np.searchsorted(edges, t, side="right"))
        xs = np.concatenate([[t], edges[i:]])
        ys = 1.0 - np.interp(xs, edges, knots, left=0.0, right=1.0)
        area = float(np.sum((ys[:-1] + ys[1:]) * np.diff(xs)) * 0.5)
        return area / st

    # -- exact piecewise integrals -------------------------------------------
    def expected_max(self, k: int) -> float:
        """``E[max of k i.i.d. draws]`` — exact under piecewise-linear CDF.

        E[max] = lo + ∫_lo^hi (1 - F(l)^k) dl.  On a segment where the CDF
        rises linearly from a to b over width w,
        ∫ F^k dl = w · (b^{k+1} - a^{k+1}) / ((k+1)(b - a)).
        """
        if k < 1:
            raise ValueError("k must be >= 1")
        cum = self.cdf_at_knots()
        a, b = cum[:-1], cum[1:]
        w = np.diff(self.edges)
        flat = np.isclose(a, b)
        seg = np.where(
            flat,
            w * a ** k,
            w * (b ** (k + 1) - a ** (k + 1)) / ((k + 1) * np.where(flat, 1.0, b - a)),
        )
        return float(self.edges[0] + np.sum(w) - np.sum(seg))


def iid_max(dist: EmpiricalDistribution, k: int) -> EmpiricalDistribution:
    """Distribution of the max of ``k`` i.i.d. draws (Eq. 6: ``F_(k)=F^k``)."""
    if k < 1:
        raise ValueError("k must be >= 1")
    if k == 1:
        return dist
    cum = dist.cdf_at_knots() ** k
    return EmpiricalDistribution(dist.edges, np.diff(cum))


def _merged_grid(
    dists: Sequence[EmpiricalDistribution], max_knots: int = 256
) -> tuple[np.ndarray, bool]:
    """Merged knot grid and whether it is *exact* (kept every input knot
    rather than subsampling past ``max_knots``)."""
    knots = np.unique(np.concatenate([d.edges for d in dists]))
    if knots.size <= max_knots:
        return knots, True
    knots = np.interp(
        np.linspace(0, 1, max_knots), np.linspace(0, 1, knots.size), knots
    )
    return np.unique(knots), False


def hetero_max(
    dists: Sequence[EmpiricalDistribution], grid: np.ndarray | None = None
) -> EmpiricalDistribution:
    """Max of independent, non-identically distributed variables (§4.2.2).

    The k-th (maximum) order statistic of independent variables has CDF
    ``Π_i F_i`` — the closed form to which Eq. 8 (Özbey et al.) reduces for
    the top order statistic.  Evaluated on the merged knot grid (pass a
    precomputed ``grid`` to skip the re-merge on repeated calls).
    """
    dists = list(dists)
    if not dists:
        raise ValueError("need at least one distribution")
    if len(dists) == 1 and grid is None:
        return dists[0]
    if grid is None:
        grid, _ = _merged_grid(dists)
    cdf = np.ones_like(grid)
    for d in dists:
        cdf = cdf * d.cdf(grid)
    probs = np.diff(cdf)
    return EmpiricalDistribution(grid, probs)


def ozbey_max_pdf(
    dists: Sequence[EmpiricalDistribution], xs: np.ndarray
) -> np.ndarray:
    """Literal Eq. 8 (Özbey et al. 2019) for the k-th order statistic PDF.

    f_(k) = Σ_{κ=1..k} (-1)^{k-κ} κ^k / k! · Σ_{|s|=κ} k [F^s]^{k-1} f^s

    with ``F^s = (1/|s|) Σ_{i∈s} F_i`` and likewise for ``f^s``.  Exponential
    in ``k`` — used only in tests to validate the product-CDF implementation.
    """
    k = len(dists)
    xs = np.asarray(xs, dtype=np.float64)
    total = np.zeros_like(xs)
    idx = range(k)
    for kappa in range(1, k + 1):
        coeff = (-1.0) ** (k - kappa) * kappa ** k / math.factorial(k)
        inner = np.zeros_like(xs)
        for s in itertools.combinations(idx, kappa):
            Fs = np.mean([dists[i].cdf(xs) for i in s], axis=0)
            fs = np.mean([_pdf(dists[i], xs) for i in s], axis=0)
            inner = inner + k * Fs ** (k - 1) * fs
        total = total + coeff * inner
    return total


def _pdf(dist: EmpiricalDistribution, xs: np.ndarray) -> np.ndarray:
    """Piecewise-constant PDF consistent with the piecewise-linear CDF."""
    xs = np.asarray(xs, dtype=np.float64)
    dens = dist.probs / np.diff(dist.edges)
    idx = np.clip(np.searchsorted(dist.edges, xs, side="right") - 1, 0, dens.size - 1)
    out = dens[idx]
    out = np.where((xs < dist.edges[0]) | (xs >= dist.edges[-1]), 0.0, out)
    return out


def mixture(
    dists: Sequence[EmpiricalDistribution],
    weights: Sequence[float] | None = None,
    grid: np.ndarray | None = None,
) -> EmpiricalDistribution:
    """Weighted mixture of app distributions (multimodal joint, §2.2/§4.3).

    Pass a precomputed ``grid`` (e.g. the scheduler's cached merged knot
    grid) to skip the per-call grid merge."""
    dists = list(dists)
    if not dists:
        raise ValueError("need at least one distribution")
    if weights is None:
        weights = [1.0] * len(dists)
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    if grid is None:
        grid, _ = _merged_grid(dists)
    cdf = np.zeros_like(grid)
    for wi, d in zip(w, dists):
        cdf = cdf + wi * d.cdf(grid)
    return EmpiricalDistribution(grid, np.diff(cdf))


@dataclasses.dataclass(frozen=True)
class BatchLatencyModel:
    """Eq. 3: ``l_B = c0 + c1 · k · l`` with ``l = max_r l_r`` (Eq. 4).

    ``bucket`` — optional padded-length bucketing (TPU static-shape regime):
    the max is rounded up to a multiple of ``bucket`` before applying the
    affine model.  ``bucket=0`` reproduces the paper's GPU model exactly.
    """

    c0: float
    c1: float
    bucket: float = 0.0

    def _bucketed(self, l: float) -> float:
        if self.bucket > 0:
            return math.ceil(l / self.bucket) * self.bucket
        return l

    def batch_time(self, alone_times_ms: Sequence[float]) -> float:
        """Ground-truth batch execution time given standalone times."""
        k = len(alone_times_ms)
        if k == 0:
            return 0.0
        return self.c0 + self.c1 * k * self._bucketed(max(alone_times_ms))

    def batch_dist(
        self, max_dist: EmpiricalDistribution, k: int
    ) -> EmpiricalDistribution:
        """Distribution of ``L_B`` given the distribution of the batch max
        (Eq. 9 is the corresponding change of variables)."""
        if k < 1:
            raise ValueError("k must be >= 1")
        d = max_dist
        if self.bucket > 0:
            # Project the max onto bucket boundaries (step function): the
            # padded length is ceil(max / bucket) · bucket, so all mass in
            # (prev_boundary, boundary] collapses to a thin bin at `boundary`.
            lo = math.floor(d.lo / self.bucket)
            hi = max(math.ceil(d.hi / self.bucket), lo + 1)
            grid = np.arange(lo, hi + 1, dtype=np.float64) * self.bucket
            pmass = np.diff(d.cdf(grid))
            vals = grid[1:]
            keep = pmass > 0
            vals, pmass = vals[keep], pmass[keep]
            if vals.size == 0:
                vals, pmass = np.array([grid[-1]]), np.array([1.0])
            width = self.bucket * 1e-3
            edges_list: list[float] = []
            probs_list: list[float] = []
            for i, v in enumerate(vals):
                edges_list.append(float(v) - width)
                edges_list.append(float(v))
                probs_list.append(float(pmass[i]))
                if i < vals.size - 1:
                    probs_list.append(0.0)  # zero-mass gap up to next bucket
            d = EmpiricalDistribution(np.array(edges_list), np.array(probs_list))
        return d.affine(self.c1 * k, self.c0)

    def expected_batch_time(
        self, dist: EmpiricalDistribution, k: int
    ) -> float:
        """Eq. 5: ``E[L_B] = c0 + c1 · k · E[max_k]`` for i.i.d. draws from
        ``dist`` (used with the mixture distribution per §4.3)."""
        if self.bucket > 0:
            return self.batch_dist(dist.iid_max(k), k).mean()
        return self.c0 + self.c1 * k * dist.expected_max(k)
