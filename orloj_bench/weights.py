"""Seeded weights, made by the benchmark on the device, and the program's
parameter tree built from them.

The weights are drawn from one ``torch.Generator`` seeded with ``--seed``,
in one large call a kind of leaf for all layers at once, in float32 (the
type they are served in).  Which leaves, their shapes, order and scales are
the family's (``families/<block_pattern>.py``, ``leaves``).  The same seed
on the same device gives the same values, so the reference makes them
again after the window instead of reading anything the program held.
"""

from __future__ import annotations

import torch

from . import families

Weights = dict[str, torch.Tensor]


def make_weights(cfg: dict, seed: int, device: str | torch.device,
                 out: Weights | None = None) -> Weights:
    """Every weight of the configuration, by its family's ``leaves``.  With
    ``out`` (an earlier result), the values are drawn into its tensors."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    w: Weights = {}
    for name, shape, init in families.of(cfg).leaves(cfg):
        if out is None:
            t = torch.randn(shape, generator=gen, device=gen.device)
        else:
            t = torch.randn(shape, generator=gen, device=gen.device, out=out[name])
        w[name] = init(t)
    return w


def port_params(cfg: dict, w: Weights) -> dict:
    """The program's parameter tree, as views of ``w``: nothing is copied."""
    return families.of(cfg).port_params(cfg, w)
