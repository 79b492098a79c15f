"""Reference parameters and decode caches → the port's, and caches back.

:func:`from_numpy` takes the parameter pytree of :class:`repro.models.Model`
with every leaf turned into a numpy array (``jax.tree.map(np.asarray,
params)`` on the caller's side; this module imports no JAX) and returns the
port's dict of tensors.  Layouts stay as they are; the one change is the
layer stack, which the port keeps as a flat list of ``n_layers`` dicts:

- a scanned stack (``scan_layers=True``) is a list of ``unit`` dicts whose
  leaves carry a leading ``n_layers / unit`` axis: units of one block, or
  xLSTM's units of ``slstm_every`` blocks (see :func:`scan_unit`).  Layer
  ``u·unit + i`` is entry ``i``, row ``u``;
- an unrolled stack is already a list of ``n_layers`` dicts.

:func:`cache_from_numpy` and :func:`cache_to_numpy` do the same for the
decode cache (``repro.models.Model.init_cache`` / ``decode_step``), stacked
the same way.  Of its leaves only the KV caches change layout: the
reference keeps them as (B, S, KV, head_dim), the port as (B, KV, S,
head_dim).  The SSM states (Mamba's ``h`` and ``conv``, the cells' ``c``,
``n`` and ``h``) keep the reference's layout.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import ModelConfig

Params = dict[str, Any]


def scan_unit(cfg: ModelConfig) -> int:
    """Blocks per scanned unit of the reference's layer stack, 0 when it is
    unrolled.  xLSTM's stack is periodic: the reference scans units of
    ``slstm_every`` blocks when the depth divides evenly and unrolls it
    otherwise (``repro.models.Model.__init__``); every other scanned stack
    has units of one block."""
    if not cfg.scan_layers:
        return 0
    if cfg.block_pattern == "xlstm":
        return cfg.slstm_every if cfg.n_layers % cfg.slstm_every == 0 else 0
    return 1


def _tree(x, leaf):
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, leaf) for v in x]
    return leaf(x)


def from_numpy(
    np_params: Params, cfg: ModelConfig, *, device: str | torch.device = "cuda"
) -> Params:
    dev = torch.device(device)

    def to_tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    out = {k: _tree(v, to_tensor) for k, v in np_params.items() if k != "blocks"}
    out["blocks"] = [_tree(b, to_tensor) for b in _per_layer(np_params["blocks"], cfg)]
    return out


def _per_layer(units: list, cfg: ModelConfig) -> list:
    """The reference's per-layer list (params or cache): as it is, or
    unstacked from the scanned units."""
    unit = scan_unit(cfg)
    if unit:
        if len(units) != unit:
            raise ValueError(f"a scanned stack has {unit} entries (one unit of {unit} blocks, each "
                             f"stacked over the units), got {len(units)}")
        return [_tree(units[i % unit], lambda a, u=i // unit: a[u]) for i in range(cfg.n_layers)]
    if len(units) != cfg.n_layers:
        raise ValueError(f"expected {cfg.n_layers} per-layer dicts, got {len(units)}")
    return units


def _map_layer_cache(cache: Params, leaf, kv_leaf) -> Params:
    """``kv_leaf`` on the KV cache's leaves, ``leaf`` on every other."""
    return {k: _tree(v, kv_leaf if k == "kv" else leaf) for k, v in cache.items()}


def cache_from_numpy(
    np_cache: list, cfg: ModelConfig, *, device: str | torch.device = "cuda"
) -> list[Params]:
    """The reference's cache, every leaf a numpy array (bfloat16 leaves as
    ``jax.numpy`` hands them over), → the port's list of per-layer caches,
    the KV caches in (B, KV, S, head_dim), same values and type."""
    dev = torch.device(device)

    def to_tensor(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # numpy's bfloat16 extension type: move the bits
            return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True))

    def leaf(a) -> torch.Tensor:
        return to_tensor(a).to(dev)

    def kv_leaf(a) -> torch.Tensor:
        return to_tensor(a).transpose(1, 2).contiguous().to(dev)

    return [_map_layer_cache(c, leaf, kv_leaf) for c in _per_layer(np_cache, cfg)]


def cache_to_numpy(cache: list[Params], cfg: ModelConfig) -> list:
    """The port's cache → the reference's layout: KV leaves in (B, S, KV,
    head_dim), stacked into the scanned units when the reference scans.
    bfloat16 leaves come back as float32, which holds every bfloat16 value
    exactly."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        return (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy()

    def kv_leaf(t: torch.Tensor) -> np.ndarray:
        return leaf(t.transpose(1, 2))

    layers = [_map_layer_cache(c, leaf, kv_leaf) for c in cache]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"expected {cfg.n_layers} per-layer caches, got {len(layers)}")
    unit = scan_unit(cfg)
    if not unit:
        return layers
    return [_stack(layers[i::unit]) for i in range(unit)]


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)
