"""Reference parameters and KV caches → the port's, and caches back.

:func:`from_numpy` takes the parameter pytree of :class:`repro.models.Model`
with every leaf turned into a numpy array (``jax.tree.map(np.asarray,
params)`` on the caller's side; this module imports no JAX) and returns the
port's dict of tensors.  Layouts stay as they are; the one change is the
layer stack:

- ``scan_layers=True``: ``params["blocks"]`` is a list of length 1 whose
  leaves carry a leading ``n_layers`` axis (one vmapped ``init_block``);
  it is unstacked into ``n_layers`` per-layer dicts.
- ``scan_layers=False``: ``params["blocks"]`` is already a list of
  ``n_layers`` dicts.

:func:`cache_from_numpy` and :func:`cache_to_numpy` do the same for the
decode cache (``repro.models.Model.init_cache`` / ``decode_step``), whose
leaves the reference keeps as (B, S, KV, head_dim) and the port as
(B, KV, S, head_dim), stacked the same way when ``scan_layers=True``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .blocks import check_supported
from .config import ModelConfig

Params = dict[str, Any]


def _tree(x, leaf):
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, leaf) for v in x]
    return leaf(x)


def from_numpy(
    np_params: Params, cfg: ModelConfig, *, device: str | torch.device = "cuda"
) -> Params:
    check_supported(cfg)
    dev = torch.device(device)

    def to_tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    out = {k: _tree(v, to_tensor) for k, v in np_params.items() if k != "blocks"}
    out["blocks"] = [_tree(b, to_tensor) for b in _per_layer(np_params["blocks"], cfg)]
    return out


def _per_layer(units: list, cfg: ModelConfig) -> list:
    """The reference's per-layer list (params or cache): as it is, or
    unstacked from the one scanned unit."""
    if cfg.scan_layers:
        if len(units) != 1:
            raise ValueError(f"a scanned stack has one unit of stacked blocks, got {len(units)}")
        return [_tree(units[0], lambda a, i=i: a[i]) for i in range(cfg.n_layers)]
    if len(units) != cfg.n_layers:
        raise ValueError(f"expected {cfg.n_layers} per-layer dicts, got {len(units)}")
    return units


def cache_from_numpy(
    np_cache: list, cfg: ModelConfig, *, device: str | torch.device = "cuda"
) -> list[Params]:
    """The reference's cache, every leaf a numpy array (bfloat16 leaves as
    ``jax.numpy`` hands them over), → the port's list of per-layer
    ``{"kv": {"k", "v"}}`` in (B, KV, S, head_dim), same values and type."""
    check_supported(cfg)
    dev = torch.device(device)

    def to_tensor(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # numpy's bfloat16 extension type: move the bits
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.transpose(1, 2).contiguous().to(dev)

    return [_tree(c, to_tensor) for c in _per_layer(np_cache, cfg)]


def cache_to_numpy(cache: list[Params], cfg: ModelConfig) -> list:
    """The port's cache → the reference's layout: (B, S, KV, head_dim)
    leaves, stacked into one unit when ``scan_layers=True``.  bfloat16
    leaves come back as float32, which holds every bfloat16 value exactly."""

    def to_array(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().transpose(1, 2).cpu().numpy()

    layers = [_tree(c, to_array) for c in cache]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"expected {cfg.n_layers} per-layer caches, got {len(layers)}")
    if not cfg.scan_layers:
        return layers
    return [_stack(layers)]


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)
