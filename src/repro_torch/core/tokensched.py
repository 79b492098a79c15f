"""Token-level (continuous batching) schedulers — DESIGN.md §12.

Autoregressive decode makes the *output length* the hidden quantity: a
request's total work is ``out_tokens`` decode iterations, revealed only when
the model emits EOS.  The token-mode analogue of the paper's unpredictable
``true_time`` is therefore the per-app output-length distribution, and the
Eq.-2/3 machinery transfers: a decode step over ``k`` active requests costs
``d0 + d1·k`` (the Eq.-3 batch-latency analogue, with prefill piggybacked at
``prefill_per_token`` per prompt token), and a request's remaining work is
the conditional expectation ``E[L − d | L > d]`` of its length distribution
given ``d`` tokens already decoded
(:meth:`~repro.core.distributions.EmpiricalDistribution.expected_remaining`).

Two schedulers share one contract (``TokenSchedulerLike`` in
:mod:`repro.core.eventloop`):

- :class:`FcfsTokenScheduler` — length-blind continuous batching: admit in
  arrival order whenever a slot is free, never drop.  The Orca-style
  baseline.
- :class:`LengthAwareTokenScheduler` — learns per-app output-length
  histograms online from observed EOS events, admits
  shortest-expected-first under a per-request feasibility test against the
  TTFT/TPOT-derived deadline (the Eq.-2 admission analogue), protects the
  running batch from joins that would blow the actives' token budgets, and
  early-drops requests that can no longer finish in time even alone
  (Algorithm-1 drop-phase analogue).

Neither scheduler reads ``out_tokens``/``slo``/``deadline`` — those derive
from the hidden output length (§3.1 partial-information constraint);
visible inputs are ``release``, ``prompt_tokens``, ``app_id``,
``tokens_done`` and the configured SLO constants.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .distributions import EmpiricalDistribution
from .request import Request
from .scheduler import Batch

__all__ = [
    "TokenSchedConfig",
    "FcfsTokenScheduler",
    "LengthAwareTokenScheduler",
    "token_deadline",
]


@dataclasses.dataclass(frozen=True)
class TokenSchedConfig:
    """Shared knobs for token-level schedulers.

    ``d0``/``d1``/``prefill_per_token`` mirror the executor's decode cost
    model (profiled offline, like handing ORLOJ the Eq.-3 fit); the TTFT /
    TPOT SLOs define each request's implied deadline
    ``release + ttft + tpot·(L−1)`` — with ``L`` hidden, the length-aware
    scheduler substitutes its learned expectation.
    """

    max_batch: int = 16
    ttft_slo_ms: float = 500.0
    tpot_slo_ms: float = 50.0
    d0: float = 2.0
    d1: float = 0.25
    prefill_per_token: float = 0.02
    n_bins: int = 12
    # Fallback mean output length for apps with no history yet.
    default_len: float = 32.0
    # Refresh an app's learned histogram every N completions.
    rebuild_every: int = 32
    # Scale on the feasibility estimate in the drop phase (>1 drops later).
    drop_safety: float = 1.0


def token_deadline(cfg: TokenSchedConfig, release: float, n_tokens: float) -> float:
    """Implied deadline of a request with ``n_tokens`` output tokens:
    first token within TTFT, each subsequent token within TPOT."""
    return release + cfg.ttft_slo_ms + cfg.tpot_slo_ms * max(n_tokens - 1.0, 0.0)


class _TokenSchedulerBase:
    """Queue plumbing shared by both token schedulers."""

    reads_request_state = False

    def __init__(self, cfg: TokenSchedConfig | None = None) -> None:
        self.cfg = cfg or TokenSchedConfig()
        self._queue: list[Request] = []  # arrival order
        self.n_timed_out = 0

    # -- arrivals ------------------------------------------------------
    def on_arrival(self, req: Request, now: float) -> None:
        self._queue.append(req)

    def on_arrivals(self, reqs: Sequence[Request], now: float) -> None:
        self._queue.extend(reqs)

    def on_arrivals_cols(self, store, lo: int, hi: int, now: float) -> None:
        self._queue.extend(store.requests[lo:hi])

    # -- atomic-batch hook: never fires in token mode ------------------
    def on_batch_done(
        self, batch: Batch, now: float, alone_times_ms: Sequence[float]
    ) -> None:
        raise TypeError(
            "token schedulers emit decode batches only; on_batch_done is "
            "an atomic-batch hook and must never be called for them"
        )

    @property
    def n_pending(self) -> int:
        return len(self._queue)


class FcfsTokenScheduler(_TokenSchedulerBase):
    """Length-blind continuous batching: FCFS admission into free slots.

    Joins waiters whenever the running batch has a free slot, in strict
    arrival order, and never drops — the Orca-style baseline the
    length-aware scheduler is judged against.
    """

    name = "token_fcfs"

    def next_batch(self, now: float) -> tuple[Batch | None, float | None]:
        if not self._queue:
            return None, None
        take = self._queue[: self.cfg.max_batch]
        del self._queue[: len(take)]
        return Batch(take, len(take), decode=True), None

    def on_decode_step(
        self, finished: Sequence[Request], n_active: int, now: float
    ) -> list[Request]:
        free = self.cfg.max_batch - n_active
        if free <= 0 or not self._queue:
            return []
        take = self._queue[:free]
        del self._queue[: len(take)]
        return take


class LengthAwareTokenScheduler(_TokenSchedulerBase):
    """Distribution-aware continuous batching (the token-mode ORLOJ).

    Admission is shortest-expected-length-first under a feasibility test:
    a waiter joins only if, at the post-join batch size ``k``, its own
    estimated finish ``now + prefill + (d0 + d1·k)·E[L]`` meets its implied
    TTFT/TPOT deadline *and* every already-active request still meets its
    own (using ``E[L − d | L > d]`` for remaining work).  Waiters that
    cannot finish in time even alone are dropped immediately (Algorithm-1
    drop-phase analogue), freeing queue pressure for feasible work.
    """

    name = "token_orloj"

    def __init__(
        self,
        cfg: TokenSchedConfig | None = None,
        initial_len_dists: dict[str, EmpiricalDistribution] | None = None,
    ) -> None:
        super().__init__(cfg)
        self._len_dists: dict[str, EmpiricalDistribution] = dict(
            initial_len_dists or {}
        )
        self._default_dist = EmpiricalDistribution.delta(self.cfg.default_len)
        self._len_obs: dict[str, list[float]] = {}
        self._active: list[Request] = []

    # -- learned output-length model -----------------------------------
    def _dist(self, app_id: str) -> EmpiricalDistribution:
        return self._len_dists.get(app_id, self._default_dist)

    def _observe(self, req: Request) -> None:
        obs = self._len_obs.setdefault(req.app_id, [])
        obs.append(float(req.tokens_done))
        if len(obs) % self.cfg.rebuild_every == 0:
            self._len_dists[req.app_id] = EmpiricalDistribution.from_samples(
                obs[-512:], n_bins=self.cfg.n_bins
            )

    def _expected_len(self, req: Request) -> float:
        return max(self._dist(req.app_id).mean(), 1.0)

    def _expected_remaining(self, req: Request) -> float:
        """``E[L − d | L > d]`` for an active request — the per-step
        conditional view that replaces a static length estimate.  The
        request is still decoding, so remaining work is at least one
        token even past the distribution's observed support."""
        return max(
            self._dist(req.app_id).expected_remaining(float(req.tokens_done)), 1.0
        )

    def _deadline_est(self, req: Request, total_len: float) -> float:
        return token_deadline(self.cfg, req.release, total_len)

    # -- admission (shared by dispatch and per-step join) --------------
    def _step_time(self, k: int) -> float:
        return self.cfg.d0 + self.cfg.d1 * k

    def _hopeless(self, req: Request, now: float) -> bool:
        """Cannot finish in time even decoding alone (k = 1)."""
        exp_len = self._expected_len(req)
        fin = (
            now
            + self.cfg.prefill_per_token * req.prompt_tokens
            + self._step_time(1) * exp_len * self.cfg.drop_safety
        )
        return fin > self._deadline_est(req, exp_len)

    def _admit(self, active: Sequence[Request], now: float) -> list[Request]:
        """Drop hopeless waiters, then admit shortest-expected-first while
        the candidate and every active request stay feasible."""
        keep: list[Request] = []
        for r in self._queue:
            if self._hopeless(r, now):
                r.dropped = now
                self.n_timed_out += 1
            else:
                keep.append(r)
        self._queue = keep
        if not keep:
            return []

        # Active requests' remaining-token budgets: deadline estimate uses
        # tokens already produced plus conditional expected remainder.
        act_rem = [self._expected_remaining(a) for a in active]
        act_dl = [
            self._deadline_est(a, a.tokens_done + rem)
            for a, rem in zip(active, act_rem)
        ]

        order = sorted(
            range(len(keep)),
            key=lambda i: (self._expected_len(keep[i]), keep[i].rid),
        )
        admitted: list[Request] = []
        adm_idx: set[int] = set()
        adm_len: list[float] = []
        k = len(active)
        for i in order:
            if k >= self.cfg.max_batch:
                break
            cand = keep[i]
            k_new = k + 1
            s = self._step_time(k_new)
            exp_len = self._expected_len(cand)
            fin = now + self.cfg.prefill_per_token * cand.prompt_tokens + s * exp_len
            if fin > self._deadline_est(cand, exp_len):
                continue  # infeasible at this batch size; stays queued
            if any(now + s * rem > dl for rem, dl in zip(act_rem, act_dl)):
                break  # joining would blow an active request's budget
            if any(now + s * el > self._deadline_est(a, el)
                   for a, el in zip(admitted, adm_len)):
                continue  # would blow an earlier joiner's budget
            admitted.append(cand)
            adm_len.append(exp_len)
            adm_idx.add(i)
            k = k_new
        if adm_idx:
            self._queue = [r for j, r in enumerate(keep) if j not in adm_idx]
        return admitted

    # -- scheduler hooks -----------------------------------------------
    def next_batch(self, now: float) -> tuple[Batch | None, float | None]:
        if not self._queue:
            return None, None
        admitted = self._admit((), now)
        if not admitted:
            return None, None
        self._active = list(admitted)
        return Batch(admitted, len(admitted), decode=True), None

    def on_decode_step(
        self, finished: Sequence[Request], n_active: int, now: float
    ) -> list[Request]:
        if finished:
            done = {r.rid for r in finished}
            for r in finished:
                self._observe(r)
            self._active = [a for a in self._active if a.rid not in done]
        joined = self._admit(self._active, now)
        self._active.extend(joined)
        return joined
