"""What the benchmark knows of one model family, one module a family, named
by the configuration's ``block_pattern`` (``attn.py``: GLM-4's decoder).

A family module gives, for a configuration's dict ``cfg``:

- ``model_config(cfg)``: the program's ``ModelConfig``;
- ``leaves(cfg)``: the ordered ``(name, shape, init)`` list of the weights
  that :func:`orloj_bench.weights.make_weights` draws, each ``init`` a
  function that scales a standard normal draw in place (:func:`normal`,
  :func:`around`);
- ``port_params(cfg, w)``: the program's parameter tree as views of ``w``;
- ``batch_flops(cfg, k, s)``: the FLOPs of one served padded (k, s) batch;
- ``flash_bound_s(cfg, k, s)``: the least seconds of the batch's flash
  forwards over all its attention layers;
- ``gemm_products(cfg, k, s)``: the ``(M, K, N)`` of every weight product of
  the batch.

Its plain reference is ``orloj_bench/reference/<block_pattern>.py``, found by
the same rule (a module named by the pattern in its package) in
``reference/__init__.py``, which imports nothing of the benchmark.  A new
family adds these two files and touches no other.  This module imports no
other of the benchmark's, so a family may import it and ``work``."""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parents[1]


def files(pattern: str) -> list[Path]:
    """The family's module and its reference's module."""
    return [ROOT / "families" / f"{pattern}.py", ROOT / "reference" / f"{pattern}.py"]


def of(cfg: dict):
    """The family module of a configuration."""
    return importlib.import_module(f"{__name__}.{cfg['block_pattern']}")


def normal(scale: float) -> Callable:
    """A leaf's init: normal(0, scale²)."""
    return lambda t: t.mul_(scale)


def around(centre: float, spread: float) -> Callable:
    """A leaf's init: normal(centre, spread²)."""
    return lambda t: t.mul_(spread).add_(centre)
