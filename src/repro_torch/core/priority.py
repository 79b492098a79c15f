"""Time-varying batch-aware priority score (paper §4.1, Eq. 2; §4.4).

For a request with deadline ``D``, miss cost ``c`` and (batch) execution-time
histogram bins ``[l1, l2)`` with frequency ``h``, the per-bin score is

             ⎧ (hc / (E[L] b)) (e^{b l2} − e^{b l1}) e^{−bD} e^{bt}   t < D − l2
    p_i(t) = ⎨ hc/(E[L] b) − (hc/(E[L] b)) e^{b l1} e^{−bD} e^{bt}   D−l2 ≤ t < D−l1
             ⎩ 0                                                     D−l1 ≤ t

so every bin (and hence the request) is of the form ``p(t) = α e^{bt} + β``
(§4.4), with regime changes ("milestones") at ``D − l2`` and ``D − l1``.

Overflow handling (§4.4): ``D`` and ``t`` are measured relative to a sliding
*base time*.  With millisecond resolution and ``b = 1e-4`` the exponentials
stay in float64 range for ~1000 s of scheduling before the base must be
reset (and all scores recomputed — Algorithm 1 lines 2–4).

Hot path (DESIGN.md §Hot-path): the bin edges are sorted, so the three
regimes partition the bins into a prefix (A: ``l2 < D − t``), a middle run
(B: ``l1 < D − t ≤ l2``) and a suffix (C).  With per-bin prefix cumulative
sums precomputed in :class:`BinScoreModel`, one score is two
``searchsorted`` lookups plus O(1) arithmetic, and :meth:`score_many`
evaluates N (deadline, cost) steps in a single vectorized pass.  The
scalar :meth:`score` is a thin wrapper over the same code path, so the two
agree bit for bit; :meth:`value_reference` remains the literal-Eq.-2 test
oracle.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .distributions import EmpiricalDistribution
from .request import PiecewiseStepCost, Request

__all__ = [
    "BinScoreModel",
    "Score",
    "DEFAULT_B",
    "RESET_EXPONENT",
    "aggregate_steps",
]

DEFAULT_B = 1e-4  # per millisecond, paper §4.4 / §5.6
# Reset the base time when b·(t − base) exceeds this (e^60 ≈ 1e26; products
# of two such terms stay well inside float64 range ~1e308).
RESET_EXPONENT = 60.0


@dataclasses.dataclass(frozen=True)
class Score:
    """A request's priority at some instant: ``p(t) = α e^{b(t−base)} + β``.

    ``milestone`` is the next absolute time at which (α, β) change.
    """

    alpha: float
    beta: float
    milestone: float

    def value(self, t: float, base: float, b: float) -> float:
        return self.alpha * math.exp(b * (t - base)) + self.beta


class BinScoreModel:
    """Priority computation for one batch-execution-time histogram.

    One instance exists per (model, batch size): the histogram is the
    distribution of ``L_B`` for that batch size derived from the mixture of
    all app distributions (§4.3), so it is shared by all requests and can be
    precomputed off the critical path.
    """

    def __init__(self, batch_dist: EmpiricalDistribution, b: float = DEFAULT_B):
        self.b = float(b)
        self.l1 = batch_dist.edges[:-1].copy()
        self.l2 = batch_dist.edges[1:].copy()
        self.h = batch_dist.probs.copy()
        self.e_l = batch_dist.mean()
        if self.e_l <= 0:
            raise ValueError("batch execution time must have positive mean")
        # Precompute bin exponentials: e^{b l1}, e^{b l2} (l in ms; b·l ≪ 1
        # for realistic latencies so these never overflow).
        self._ebl1 = np.exp(self.b * self.l1)
        self._ebl2 = np.exp(self.b * self.l2)
        self._k = 1.0 / (self.e_l * self.b)  # hc/(E[L] b) sans h·c
        # Prefix cumulative sums over the sorted bins (leading 0 so that
        # P[j] − P[i] sums bins [i, j)): with them a score is two
        # searchsorted lookups plus O(1) arithmetic instead of an O(bins)
        # masked reduction (DESIGN.md §Hot-path).
        self._p_gap = np.concatenate(
            [[0.0], np.cumsum(self.h * (self._ebl2 - self._ebl1))]
        )
        self._p_el1 = np.concatenate([[0.0], np.cumsum(self.h * self._ebl1)])
        self._p_h = np.concatenate([[0.0], np.cumsum(self.h)])

    # ------------------------------------------------------------------
    def score_many(
        self,
        deadlines: np.ndarray,
        costs: np.ndarray,
        t: float,
        base: float,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized Eq.-2 scoring of N single-step (deadline, cost) pairs.

        Returns ``(alpha, beta, milestone)`` arrays; ``milestone`` is the
        next absolute regime-change time (``inf`` when none remains).
        Piecewise-step costs decompose into flat step arrays (Appendix B);
        fold the per-step rows back with :func:`aggregate_steps`.

        Closed form: the bins are sorted, so at slack ``s = D − t`` the
        regime-A bins are the prefix ``l2 < s`` (count ``iA``) and the
        regime-B bins are the run ``[iA, iB)`` with ``iB = #{l1 < s}``:

            α = (hc/(E[L]b)) e^{−bD} (P_gap[iA] − (P_el1[iB] − P_el1[iA]))
            β = (hc/(E[L]b)) (P_h[iB] − P_h[iA])
        """
        d = np.asarray(deadlines, dtype=np.float64)
        c = np.asarray(costs, dtype=np.float64)
        s = d - t  # slack until each step's deadline
        i_a = np.searchsorted(self.l2, s, side="left")
        i_b = np.searchsorted(self.l1, s, side="left")
        ebD = np.exp(-self.b * (d - base))
        kc = self._k * c
        alpha = kc * ebD * (
            self._p_gap[i_a] - (self._p_el1[i_b] - self._p_el1[i_a])
        )
        beta = kc * (self._p_h[i_b] - self._p_h[i_a])
        # Next milestone: the regime-A bins' D − l2 are decreasing in the
        # bin index, so the nearest future one is bin iA−1; likewise D − l1
        # at iB−1.  Regimes are tested in slack space (l2 < D − t) but
        # milestones are emitted in time space (D − l2); when the time-space
        # float rounds down the candidate can land AT t — re-scoring at
        # exactly that instant (the event loop wakes there) would see its
        # own wake time again and a naive `> now` filter would drop every
        # later milestone with it.  Advance such candidates to the next
        # strictly-future edge instead (the scores are continuous across a
        # regime change, so the ulp-late attribution is harmless).
        m_a = self._next_future(self.l2, i_a, d, t)
        m_b = self._next_future(self.l1, i_b, d, t)
        return alpha, beta, np.minimum(m_a, m_b)

    @staticmethod
    def _next_future(
        edges: np.ndarray, idx: np.ndarray, d: np.ndarray, t: float
    ) -> np.ndarray:
        """min of {d − edges[j] : j < idx} that is strictly > t (else inf).

        ``d − edges[j]`` decreases in j, so the candidate is j = idx−1,
        stepping left only in the ulp-coincidence case above."""
        i = idx
        m = np.where(i > 0, d - edges[np.maximum(i - 1, 0)], np.inf)
        stale = (i > 0) & (m <= t)
        while np.any(stale):
            i = np.where(stale, i - 1, i)
            m = np.where(i > 0, d - edges[np.maximum(i - 1, 0)], np.inf)
            stale = (i > 0) & (m <= t)
        return m

    def score(self, req: Request, t: float, base: float) -> Score:
        """Priority of ``req`` at time ``t`` (supports piecewise-step costs
        via the Appendix-B decomposition).  Thin wrapper over
        :meth:`score_many` so scalar and vectorized paths agree bit for
        bit."""
        cost_fn = req.cost_fn()
        if isinstance(cost_fn, PiecewiseStepCost):
            steps = cost_fn.steps()
            d = np.array([s.deadline for s in steps])
            c = np.array([s.cost for s in steps])
            alpha, beta, milestone = aggregate_steps(
                *self.score_many(d, c, t, base), np.array([0])
            )
        else:
            alpha, beta, milestone = self.score_many(
                np.array([cost_fn.deadline]), np.array([cost_fn.cost]), t, base
            )
        return Score(float(alpha[0]), float(beta[0]), float(milestone[0]))

    def value(self, req: Request, t: float, base: float) -> float:
        """Direct evaluation of p(t) — used by tests as the oracle."""
        s = self.score(req, t, base)
        return s.value(t, base, self.b)

    def value_reference(self, req: Request, t: float, base: float) -> float:
        """Literal Eq. 2 evaluation, bin by bin, no (α, β) folding."""
        cost_fn = req.cost_fn()
        steps = (
            cost_fn.steps() if isinstance(cost_fn, PiecewiseStepCost) else [cost_fn]
        )
        total = 0.0
        for step in steps:
            d_rel = step.deadline - base
            t_rel = t - base
            for l1, l2, h in zip(self.l1, self.l2, self.h):
                k = h * step.cost / (self.e_l * self.b)
                if t_rel < d_rel - l2:
                    total += (
                        k
                        * (math.exp(self.b * l2) - math.exp(self.b * l1))
                        * math.exp(-self.b * d_rel)
                        * math.exp(self.b * t_rel)
                    )
                elif t_rel < d_rel - l1:
                    total += k - k * math.exp(self.b * l1) * math.exp(
                        -self.b * d_rel
                    ) * math.exp(self.b * t_rel)
        return float(total)


def aggregate_steps(
    alpha: np.ndarray,
    beta: np.ndarray,
    milestone: np.ndarray,
    seg_starts: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fold per-step :meth:`BinScoreModel.score_many` rows into per-request
    rows: segment ``i`` spans ``seg_starts[i] : seg_starts[i+1]`` (Appendix-B
    sum of single-step scores; milestones take the segment min).  Both the
    scalar and the batched scheduler paths aggregate through this helper, so
    multi-step requests score identically everywhere."""
    return (
        np.add.reduceat(alpha, seg_starts),
        np.add.reduceat(beta, seg_starts),
        np.minimum.reduceat(milestone, seg_starts),
    )
