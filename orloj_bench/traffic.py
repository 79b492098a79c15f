"""The one traffic generator: an open-loop arrival stream from a traffic file
(rate, SLO, the mix it draws from) and a mix file (the prompt lengths).

Every seed serves the same schedule, one trace of the traffic: the prompt
lengths are drawn from the mix's own ``base_seed``, and the gaps between
arrivals are the quantiles of the exponential at the traffic's rate (a
Poisson stream) in an order drawn from that ``base_seed`` too.  ``--seed``
draws the token ids (and, elsewhere, the weights and the checked sample).
So no seed changes the work of the window or when it arrives: with the
order drawn from ``--seed``, GLM-4-9B's p95 latency read 216.5, 255.3 and
285.2 ms on three seeds at 30 s on one H100, a spread no bound can hold.
The tails a run reports are therefore those of one trace of some hundreds
of requests.

A mix's ``lengths`` is a list of components, each with a ``weight`` and
either a normal (``mean``, ``std``; clipped to ``[min_len, max_len]`` and
truncated to an integer, as ``repro_torch.launch.serve.length_sampler``) or
a ``uniform`` integer range ``[lo, hi]``.  Requests at or below the median
of the mix's warm sample belong to the app ``short``, the rest to ``long``
(``TorchServingEngine.make_requests``'s split).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """``orloj_bench/<kind>/<name>.json``."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def draw_lengths(mix: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    comps = mix["lengths"]
    weights = np.array([c["weight"] for c in comps], np.float64)
    which = rng.choice(len(comps), size=n, p=weights / weights.sum())
    out = np.empty(n, np.int64)
    for i, c in enumerate(comps):
        sel = which == i
        m = int(sel.sum())
        if "uniform" in c:
            lo, hi = c["uniform"]
            out[sel] = rng.integers(lo, hi + 1, size=m)
        else:
            x = np.clip(rng.normal(c["mean"], c["std"], size=m), mix["min_len"], mix["max_len"])
            out[sel] = x.astype(np.int64)
    return out


def bucket_of(length: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt of {length} tokens is longer than the largest bucket {buckets[-1]}")


@dataclasses.dataclass
class Stream:
    """One run's arrivals: release (ms), prompt tokens and app of each request,
    and the warm sample the scheduler's per-app distributions start from."""

    release_ms: np.ndarray
    prompts: list[np.ndarray]
    apps: list[str]
    warm: dict[str, np.ndarray]  # app -> bucket sizes of the warm sample
    slo_ms: float


# The schedule spans the longest window a run may measure and 20% more: a
# shorter window serves a prefix of the same schedule.
SCHEDULE_MS = 51_000.0


def make_stream(traffic: dict, mix: dict, seed: int, horizon_ms: float,
                buckets: tuple[int, ...]) -> Stream:
    """Arrivals that cover ``max(horizon_ms, SCHEDULE_MS)`` and 20% more, so
    the window never runs dry."""
    rate = float(traffic["rate_rps"])
    n = int(math.ceil(rate * max(horizon_ms, SCHEDULE_MS) / 1e3 * 1.2)) + 16
    base = np.random.default_rng(mix["base_seed"])
    lengths = draw_lengths(mix, base, n)
    warm = draw_lengths(mix, np.random.default_rng([mix["base_seed"], 1]), mix["warm_n"])
    split = float(np.median(warm))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate * 1e3  # exponential quantiles, ms

    release = np.cumsum(gaps[np.random.default_rng([mix["base_seed"], 2]).permutation(n)])
    rng = np.random.default_rng([seed, 7])
    lo, hi = mix["token_ids"]
    prompts = [rng.integers(lo, hi, size=int(k)).astype(np.int32) for k in lengths]
    apps = ["short" if k <= split else "long" for k in lengths]
    sizes = np.array([bucket_of(int(k), buckets) for k in warm], np.float64)
    return Stream(
        release_ms=release,
        prompts=prompts,
        apps=apps,
        warm={"short": sizes[warm <= split], "long": sizes[warm > split]},
        slo_ms=float(traffic["slo_ms"]),
    )
