"""Training data pipeline: synthetic corpus + batch iterator on the device.

The counterpart of :mod:`repro.data.pipeline`.  :class:`DataConfig` and
:class:`SyntheticCorpus` are the reference's, line for line (pure numpy:
the same seed gives the same token stream in both packages; a test holds
their source to the reference's).  The corpus draws every token on the
host, a Zipf unigram draw (``rng.choice`` over the vocabulary) or a Markov
continuation, so its time grows with the vocabulary; it is the reference's
stream, and stays as it is.  :func:`make_train_iterator` yields the
batches as int64 tensors on one device, or, given a device mesh, placed
on it as the reference places them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32_000
    seq_len: int = 512
    batch_size: int = 8
    zipf_a: float = 1.3
    markov_order: int = 2
    seed: int = 0


class SyntheticCorpus:
    """Zipf unigrams re-weighted by a sparse bigram transition table."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = ranks ** (-cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # Each token prefers a small random successor set.
        self.succ = self.rng.integers(0, v, size=(v, 4))

    def sample_row(self) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len + 1, np.int32)
        out[0] = self.rng.choice(cfg.vocab_size, p=self.unigram)
        for i in range(1, cfg.seq_len + 1):
            if self.rng.random() < 0.7:  # Markov continuation
                out[i] = self.succ[out[i - 1], self.rng.integers(0, 4)]
            else:
                out[i] = self.rng.choice(cfg.vocab_size, p=self.unigram)
        return out

    def batch(self) -> dict[str, np.ndarray]:
        rows = np.stack([self.sample_row() for _ in range(self.cfg.batch_size)])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_train_iterator(
    cfg: DataConfig, device: str | torch.device = "cuda", *, mesh=None
) -> Iterator[dict[str, torch.Tensor]]:
    """The corpus's batches, ``tokens`` and ``labels`` (batch, seq_len)
    int64, on ``device`` (the card unless the caller asks for the CPU).
    With a device ``mesh``, each batch is a pair of DTensors on it instead,
    the batch over (pod, data) as the reference places it (each rank keeps
    its own rows)."""
    corpus = SyntheticCorpus(cfg)
    if mesh is not None:
        from ..models.sharding import batch_spec, place

        spec = batch_spec(None, mesh, cfg.batch_size, 2)
        while True:
            b = {k: torch.from_numpy(v.astype(np.int64)) for k, v in corpus.batch().items()}
            yield place(b, mesh, {k: spec for k in b})
    dev = resolve_device(device)
    while True:
        b = corpus.batch()
        yield {k: torch.from_numpy(v.astype(np.int64)).to(dev) for k, v in b.items()}
