"""Checkpoints of the port's parameters in the reference's files: one flat
npz of leaves a step, ``step_%08d.npz``, keyed by each leaf's path in the
reference's parameter pytree joined with ``§`` (``blocks§0§attn§wq``).

The counterpart of :mod:`repro.checkpoint.store`.  The port keeps its layer
stack as a per-layer list, the reference scans a stacked one; a checkpoint
holds the reference's layout (:func:`repro_torch.models.convert.to_numpy`),
so each package restores the other's files.  ``treedef.json`` holds, under
the reference's key ``repr``, a description of the tree: the reference
writes ``str`` of a JAX treedef there, which the port cannot make, and
neither package's restore reads it.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.convert import from_numpy, reference_tree, to_numpy
from ..models.sharding import full_tensor, place

_SEP = "§"


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> dict[str, Any]:
    """{path joined with §: leaf} over dicts and lists, as the reference
    names a pytree's leaves (dict keys, list indices); anything else, a
    tuple of a shape included, is a leaf."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    flat: dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, (*prefix, k)))
    return flat


def _unflatten(like: Any, values: dict[str, Any], prefix: tuple[str, ...] = ()) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, values, (*prefix, str(k))) for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten(v, values, (*prefix, str(i))) for i, v in enumerate(like)]
    return values[_SEP.join(prefix)]


def save_checkpoint(ckpt_dir: str | Path, step: int, params: Any, cfg: ModelConfig) -> Path:
    """Write the port's ``params`` of model ``cfg`` as step ``step`` (DTensor
    leaves gathered whole first)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(to_numpy(full_tensor(params), cfg))
    path = ckpt_dir / f"step_{step:08d}.npz"
    np.savez(path, **flat)
    desc = f"repro_torch {cfg.name}: {len(flat)} leaves: " + ", ".join(sorted(flat))
    (ckpt_dir / "treedef.json").write_text(json.dumps({"repr": desc}))
    return path


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = [
        int(m.group(1))
        for p in ckpt_dir.glob("step_*.npz")
        if (m := re.match(r"step_(\d+)\.npz", p.name))
    ]
    return max(steps) if steps else None


def restore_checkpoint(
    ckpt_dir: str | Path, step: int, like: Any, cfg: ModelConfig, *,
    device: str | torch.device | None = None, shardings: Any | None = None, mesh=None,
) -> Any:
    """The parameters of step ``step``, in the structure of ``like`` (the
    port's parameters of model ``cfg``), on ``device`` (default: like's).
    With ``shardings``, a tree of specs matching ``like`` (as
    :func:`repro_torch.models.sharding.param_specs` gives them), each leaf
    is placed on the device ``mesh`` instead, each rank keeping its own
    shard; the file holds whole leaves, so a checkpoint written under one
    mesh restores under another.  Raises on a missing key (KeyError) or a
    shape other than like's (ValueError), as the reference does."""
    path = Path(ckpt_dir) / f"step_{step:08d}.npz"
    shapes = reference_tree(like, cfg, lambda t: tuple(t.shape),
                            lambda s: (len(s), *s[0]))
    want = _flatten(shapes)
    with np.load(path) as data:
        values = {}
        for key, shape in want.items():
            arr = data[key]
            if arr.shape != shape:
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {shape}")
            values[key] = arr
    if shardings is not None:
        if mesh is None:
            raise ValueError("shardings need the device mesh they are specs on")
        return place(from_numpy(_unflatten(shapes, values), cfg, device="cpu"), mesh, shardings)
    if device is None:
        device = next(iter(_flatten(like).values())).device
    return from_numpy(_unflatten(shapes, values), cfg, device=device)
