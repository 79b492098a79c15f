"""Padded-batch construction for the real-execution engine.

TPU/XLA serve static shapes: sequence lengths are bucketed (multiples of a
bucket size, one compiled program per bucket) and the batch is padded to
``bucket(max_r len_r)`` — the concrete mechanism behind the paper's Eq. 4
(`l = max_r l_r`) on an XLA backend.

``buckets`` is an ascending tuple of supported sequence lengths.  Payloads
longer than the largest bucket cannot be represented: by default batch
construction *raises* rather than silently truncating user tokens; callers
that have already clamped at admission (the engine's request generator
caps lengths at the largest bucket) may pass ``overflow="clamp"`` to
truncate explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.request import Request

__all__ = ["PaddedBatch", "make_padded_batch", "bucket_for", "padded_batch_size"]


def padded_batch_size(k: int, batch_sizes: Sequence[int]) -> int:
    """The batch size actually executed for ``k`` requests: the next
    supported size (XLA static-shape regime; batch-size buckets as in
    Clockwork), or ``k`` itself beyond the largest supported size."""
    if not batch_sizes:
        raise ValueError(
            "batch_sizes is empty: the engine needs at least one supported "
            "batch size to execute anything"
        )
    for bs in batch_sizes:
        if k <= bs:
            return bs
    return k


def bucket_for(length: int, buckets: tuple[int, ...], *, clamp: bool = True) -> int:
    """Smallest bucket holding ``length`` tokens.

    ``buckets`` must be ascending.  For ``length`` beyond the largest
    bucket, returns the largest bucket when ``clamp`` (the request will be
    truncated to fit) and raises otherwise."""
    if length < 0:
        raise ValueError(f"negative sequence length {length}")
    if not buckets:
        raise ValueError(
            "buckets is empty: the engine needs at least one sequence-length "
            "bucket to pad into"
        )
    for b in buckets:
        if length <= b:
            return b
    if clamp:
        return buckets[-1]
    raise ValueError(
        f"sequence length {length} exceeds the largest bucket {buckets[-1]}"
    )


@dataclasses.dataclass
class PaddedBatch:
    tokens: np.ndarray  # (k, bucket) int32, zero-padded
    lengths: np.ndarray  # (k,) int32 — post-clamp payload lengths
    labels_bucket: int
    requests: list[Request]


def make_padded_batch(
    requests: list[Request],
    buckets: tuple[int, ...],
    pad_id: int = 0,
    overflow: str = "error",
) -> PaddedBatch:
    """Pad each request's token payload to the bucket of the batch max.

    ``overflow`` controls payloads longer than the largest bucket:
    ``"error"`` (default) raises; ``"clamp"`` truncates them to the largest
    bucket and reports the clamped length in ``PaddedBatch.lengths``.
    """
    if overflow not in ("error", "clamp"):
        raise ValueError(f"overflow must be 'error' or 'clamp', got {overflow!r}")
    if not requests:
        raise ValueError(
            "cannot build a padded batch from an empty request list: "
            "callers must not dispatch empty batches"
        )
    if not buckets:
        raise ValueError(
            "buckets is empty: the engine needs at least one sequence-length "
            "bucket to pad into"
        )
    lengths = np.array([len(r.payload) for r in requests], np.int32)
    max_bucket = buckets[-1]
    if overflow == "error" and int(lengths.max()) > max_bucket:
        over = [
            (r.rid, int(n)) for r, n in zip(requests, lengths) if n > max_bucket
        ]
        raise ValueError(
            f"payloads exceed the largest bucket ({max_bucket}): "
            f"(rid, len)={over}; reject at admission or pass overflow='clamp'"
        )
    lengths = np.minimum(lengths, max_bucket)
    bucket = bucket_for(int(lengths.max()), buckets)
    tokens = np.full((len(requests), bucket), pad_id, np.int32)
    for i, r in enumerate(requests):
        tokens[i, : lengths[i]] = np.asarray(r.payload, np.int32)[: lengths[i]]
    return PaddedBatch(tokens, lengths, bucket, requests)
