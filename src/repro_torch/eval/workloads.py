"""JSON-addressable workload families for the experiment grid.

An :class:`~repro.eval.spec.ExperimentSpec` names its workload as
``(family, params)`` where ``params`` is a plain JSON object — so a grid
cell can be serialized, shipped to another process, and regenerated there
bit-for-bit.  Each family maps onto one of the §5 synthesis helpers in
:mod:`repro.serving.workload`.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np

from ..serving.workload import (
    AppWorkload,
    bimodal,
    k_modal,
    real_task,
    static,
    unequal_bimodal,
)

__all__ = ["FAMILIES", "build_workload"]


def _bimodal(params: Mapping) -> list[AppWorkload]:
    std = params.get("std", 1.0)
    if isinstance(std, (list, tuple)):  # JSON carries tuples as lists
        std = tuple(float(s) for s in std)
    return bimodal(std)


def _unequal_bimodal(params: Mapping) -> list[AppWorkload]:
    return unequal_bimodal(params.get("more", "short"), params.get("std", 1.0))


def _k_modal(params: Mapping) -> list[AppWorkload]:
    return k_modal(
        int(params["k"]),
        std=params.get("std", 1.0),
        lo=params.get("lo", 30.0),
        hi=params.get("hi", 200.0),
    )


def _static(params: Mapping) -> list[AppWorkload]:
    return static(params.get("mean", 10.0), params.get("jitter", 0.02))


def _real(params: Mapping) -> list[AppWorkload]:
    return real_task(params["name"])


def _tokens(params: Mapping) -> list[AppWorkload]:
    """Token-mode family (DESIGN.md §12): the samplers draw *output
    lengths in tokens* (geometric, the memoryless EOS model), not
    alone-times in ms — :func:`repro.serving.trace.generate_token_requests`
    interprets them accordingly.  Bimodal by default: a short-form app
    (chat-style) and a long-form app (summarization-style)."""

    def geometric(mean: float) -> Callable[[np.random.Generator, int], np.ndarray]:
        p = 1.0 / max(mean, 1.0)

        def f(rng: np.random.Generator, n: int) -> np.ndarray:
            return rng.geometric(p, size=n).astype(np.float64)

        return f

    w_short = float(params.get("short_weight", 0.5))
    return [
        AppWorkload("short", geometric(float(params.get("short_mean", 8.0))), w_short),
        AppWorkload(
            "long", geometric(float(params.get("long_mean", 64.0))), 1.0 - w_short
        ),
    ]


FAMILIES: dict[str, Callable[[Mapping], list[AppWorkload]]] = {
    "bimodal": _bimodal,
    "unequal_bimodal": _unequal_bimodal,
    "k_modal": _k_modal,
    "static": _static,
    "real": _real,
    "tokens": _tokens,
}

# Families with data-dependent execution-time variance — the regime where
# the paper claims dominance under tight SLOs; ``static`` is the
# no-variance control where parity is the claim (Tables 2–5).  ``tokens``
# is deliberately absent: token cells compare token schedulers against
# each other (claim ``token-length-awareness``), never against the
# atomic-batch systems the paper orderings are about.
DYNAMIC_FAMILIES = frozenset({"bimodal", "unequal_bimodal", "k_modal", "real"})


def _scaled_app(app: AppWorkload, scale: float) -> AppWorkload:
    sampler = app.sampler

    def f(rng: np.random.Generator, n: int) -> np.ndarray:
        return sampler(rng, n) * scale

    return type(app)(app.app_id, f, app.weight)


def build_workload(
    family: str, params: Mapping, time_scale: float = 1.0
) -> list[AppWorkload]:
    """Materialize the per-app samplers for a spec's ``(family, params)``.

    ``time_scale`` multiplies every sampled alone-time — the Fig.-14
    shrinking-execution-time study, applied uniformly so the workload's
    *shape* is preserved.
    """
    try:
        apps = FAMILIES[family](params)
    except KeyError:
        raise ValueError(
            f"unknown workload family {family!r}; known: {sorted(FAMILIES)}"
        ) from None
    if time_scale != 1.0:
        apps = [_scaled_app(a, time_scale) for a in apps]
    return apps
