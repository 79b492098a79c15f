"""Reference parameters → the port's parameters.

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

    blocks = np_params["blocks"]
    if cfg.scan_layers:
        if len(blocks) != 1:
            raise ValueError(
                f"a scanned stack has one unit of stacked blocks, got {len(blocks)}"
            )
        stacked = blocks[0]
        blocks = [_tree(stacked, lambda a, i=i: a[i]) for i in range(cfg.n_layers)]
    elif len(blocks) != cfg.n_layers:
        raise ValueError(f"expected {cfg.n_layers} per-layer dicts, got {len(blocks)}")
    out = {k: _tree(v, to_tensor) for k, v in np_params.items() if k != "blocks"}
    out["blocks"] = [_tree(b, to_tensor) for b in blocks]
    return out
