"""AdamW with global-norm clipping and a cosine LR schedule, over the port's
parameter tree (dicts and lists of tensors).

The counterpart of :mod:`repro.optim.adamw`, with its arithmetic: the
gradient norm is taken over every leaf in float32 (summed leaf by leaf in
the reference's order, dict keys sorted); the bias corrections are
``b ** step`` in float32; weight decay applies to every leaf, norm scales,
biases and the embedding included; ``m`` and ``v`` start as zeros of each
parameter's shape and type, and ``step`` is an int32 tensor.

:func:`adamw_update` updates the parameters and the moments **in place**
(the reference returns new trees): at GLM-4-9B's width the parameters and
moments are 25 GB, and a second copy would not fit beside the gradients.
Each leaf's new values are computed as the reference computes them and
then copied in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def leaves(tree: Params) -> list[torch.Tensor]:
    """The tensors of a tree in the reference's flattening order: dict
    keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def _map(tree: Params, fn) -> Params:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def adamw_init(params: Params) -> dict:
    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    with torch.no_grad():
        return {"m": _map(params, torch.zeros_like), "v": _map(params, torch.zeros_like),
                "step": step}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params, state: dict) -> tuple[Params, dict]:
    """One AdamW step.  ``grads`` has the structure of ``params``, or is the
    list of the gradients of its :func:`leaves`, in their order.  Updates
    ``params`` and the moments in place and returns (params, state)."""
    step = state["step"] + 1
    flat_p, flat_g = leaves(params), leaves(grads)
    flat_m, flat_v = leaves(state["m"]), leaves(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"{len(flat_p)} parameters, {len(flat_g)} gradients, {len(flat_m)} and "
                         f"{len(flat_v)} moments")
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat_g))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_schedule(cfg, step)
    stepf = step.float()
    c1 = 1 - cfg.b1 ** stepf
    c2 = 1 - cfg.b2 ** stepf
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m2 / c1
        vhat = v2 / c2
        upd = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p - lr * upd.to(p.dtype))
        m.copy_(m2)
        v.copy_(v2)
    return params, {"m": state["m"], "v": state["v"], "step": step}
