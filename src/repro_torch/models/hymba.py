"""Hymba at its published widths (arXiv:2411.13676): the options the port
adds to :class:`ModelConfig` for it, and the layout of attention and the
decode cache that they set.

``models/config.py`` is a byte copy of the reference's, whose Hymba has a
Mamba as wide as the model, a dt rank of 16, one sliding window for every
layer, no meta tokens and no shared K/V.  :class:`HymbaConfig` adds, with
defaults that reproduce that block exactly:

- ``ssm_expand``: the Mamba's inner width over ``d_model`` (published: 2);
- ``dt_rank``: the rank of Δ's projection (published: 100);
- ``n_meta_tokens``: learned (``n_meta_tokens``, d) embeddings (the
  ``"meta"`` leaf) joined in front of every prompt (published: 128).
  Every query sees them, in the windowed layers too (the flash kernel's
  ``prefix``), and their positions are dropped before the head;
- ``global_layers``: the layers that attend to every earlier position
  (published: 0, 15 and 31); the others keep ``sliding_window``;
- ``kv_share``: consecutive windowed layers pair up, the first of each
  pair computing K and V and the second attending with them: it has no
  ``wk``/``wv`` and no K/V cache of its own; a global layer keeps its own.

The blocks and the model (:mod:`.blocks`, :class:`.Model`) read these
options through :func:`options` for every configuration: another
configuration has the defaults, which are the layout every other block
already had.  The decode cache of a windowed layer holds the meta tokens'
K/V in its first ``n_meta_tokens`` slots and a ring of ``sliding_window``
slots after them (:func:`cache_slots`, :func:`slot_of`); a global layer's
holds every position.  Positions count the meta tokens.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class HymbaConfig(ModelConfig):
    ssm_expand: int = 1
    dt_rank: int = 16
    n_meta_tokens: int = 0
    global_layers: tuple[int, ...] = ()
    kv_share: bool = False

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def window(self, i: int) -> int:
        """Layer i's sliding window (0: it attends to every position)."""
        return 0 if i in self.global_layers else self.sliding_window

    def kv_sources(self) -> tuple[int, ...]:
        """For each layer, the layer whose K and V it attends with: itself,
        or, where ``kv_share`` pairs consecutive windowed layers, the first
        of its pair."""
        src: list[int] = []
        for i in range(self.n_layers):
            pair = (self.kv_share and i > 0 and self.window(i) > 0 and self.window(i - 1) > 0
                    and src[i - 1] == i - 1)
            src.append(i - 1 if pair else i)
        return tuple(src)


@functools.cache
def options(cfg: ModelConfig) -> HymbaConfig:
    """``cfg``'s Hymba options: a :class:`HymbaConfig`'s own, the defaults
    for any other configuration."""
    if isinstance(cfg, HymbaConfig):
        return cfg
    return HymbaConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def cache_slots(cfg: ModelConfig, i: int, cache_len: int) -> int:
    """Slots of layer i's K/V cache over ``cache_len`` positions (meta tokens
    included): the meta tokens and a ring of the window for a windowed
    layer, every position for a global one."""
    hy = options(cfg)
    w = hy.window(i)
    return min(cache_len, hy.n_meta_tokens + w) if w else cache_len


def slot_of(cfg: ModelConfig, i: int, pos: torch.Tensor, slots: int) -> torch.Tensor:
    """The cache slot of position ``pos`` in layer i's cache of ``slots``."""
    hy = options(cfg)
    p = hy.n_meta_tokens
    if not hy.window(i):
        return pos
    return torch.where(pos < p, pos, p + (pos - p) % (slots - p))
