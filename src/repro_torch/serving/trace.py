"""Arrival-rate helper of the engine's request generator.

Only :func:`offered_rate` is ported: the rest of the reference
``serving/trace.py`` pulls in the multi-model residency tier and, through
it, the whole architecture zoo."""

from __future__ import annotations

import numpy as np

from ..core.distributions import BatchLatencyModel

__all__ = ["offered_rate"]


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
