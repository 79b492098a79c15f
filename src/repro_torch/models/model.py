"""Model assembly of the port: embeddings (or a frontend's projected
embeddings) + decoder blocks + head.

The counterpart of :class:`repro.models.Model`: the forward
(``hidden_states`` / ``logits``), the training loss (``loss``), ``prefill``,
and one-token decoding over a cache (``init_cache`` / ``decode_step``), for
every block kind of the zoo (attention, MoE, Hymba, xLSTM) and both
frontends, and Hymba's options beyond the reference's configuration
(:class:`.hymba.HymbaConfig`: meta tokens joined in front of the prompt,
global and windowed layers, K/V shared by pairs of layers).  Parameters
are a dict of tensors in the JAX layout, passed explicitly as in the
reference; the per-layer parameters are always a list of ``n_layers``
dicts (the scanned, stacked layout of the reference is unstacked by
:mod:`.convert`), and so is the cache: a list of ``n_layers``
per-layer dicts (see :func:`.blocks.init_block_cache`), the KV caches in
the decode kernel's (B, KV, S, head_dim) layout.

Numerics follow the reference, quirks included: the token embedding is
cast to ``cfg.dtype`` and then scaled by a float32 √d, which JAX promotes
to float32, so a "bfloat16" config computes every later layer in float32.
An audio model has no token embedding: its frame embeddings are projected
in ``cfg.dtype`` and the whole stack computes in it (bfloat16 for
MusicGen).  A vision prefix is projected in ``cfg.dtype`` and joined to the
float32 tokens, which JAX promotes to float32.

Recomputation (``cfg.remat``) wraps each block in
``torch.utils.checkpoint`` when grad mode is on, as the reference wraps its
scanned unit (or each unrolled block) in ``jax.checkpoint``: nothing is
saved between blocks (``nothing_saveable``), or, with ``remat_policy ==
"dots"``, the outputs of the 2-D matrix products are kept
(``dots_with_no_batch_dims_saveable``).  The backward re-runs each block's
forward, so its kernels launch twice.  It is refused where layers share
K/V: the recomputed layer would not hand its K/V to its partner again.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import resolve_device
from . import hymba
from .blocks import block_apply, block_decode, init_block, init_block_cache
from .config import ModelConfig
from .hymba import HymbaConfig
from .sharding import gather_last, linear
from .layers import (
    DecodeSlot,
    _init,
    decode_slot,
    embed_apply,
    init_embedding,
    init_norm,
    norm_apply,
    unembed_apply,
)

Params = dict[str, Any]

FRONTEND_DIMS = {"vision": 1024, "audio": 512}

# Matrix products without a batch dimension: what the reference's "dots"
# policy keeps (dots_with_no_batch_dims_saveable); a block's (B, S, d) @ W
# reaches aten as a 2-D mm.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(cfg: ModelConfig) -> dict:
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                _dots_policy)}
    return {}


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)

    # ------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Params:
        """Draw parameters of the reference's shapes and scales from
        ``generator``, on the generator's device (which must be the
        model's).  The values differ from ``repro``'s ``jax.random`` draws."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        cfg = self.cfg
        params: Params = {}
        if cfg.frontend != "audio":
            params["embed"] = init_embedding(generator, cfg.vocab_size, cfg.d_model)
        if n_meta := hymba.options(cfg).n_meta_tokens:
            params["meta"] = _init(generator, (n_meta, cfg.d_model), scale=1.0)
        if cfg.frontend:
            params["frontend_proj"] = _init(generator, (self.frontend_dim, cfg.d_model))
        params["blocks"] = [init_block(generator, cfg, i) for i in range(cfg.n_layers)]
        params["final_norm"] = init_norm(generator, cfg.d_model, cfg.norm)
        if not cfg.tie_embeddings:
            params["lm_head"] = _init(
                generator, (cfg.d_model, cfg.vocab_size), scale=1.0 / math.sqrt(cfg.d_model)
            )
        return params

    @property
    def frontend_dim(self) -> int:
        return FRONTEND_DIMS.get(self.cfg.frontend, 0)

    # ----------------------------------------------------------- forward
    def _embed_tokens(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        # bfloat16 × float32 scalar is float32 in JAX; torch would keep bf16.
        return embed_apply(params["embed"], tokens, self.dtype).float() * math.sqrt(
            self.cfg.d_model
        )

    def _project_frontend(self, params: Params, embeds: torch.Tensor) -> torch.Tensor:
        return linear(embeds.to(self.dtype), params["frontend_proj"].to(self.dtype))

    def _embed_inputs(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """The stack's input: the projected frontend embeddings (vision: a
        prefix; audio: the whole input, in ``cfg.dtype``), then the embedded
        tokens (not for audio), joined in the promoted type as JAX joins them."""
        cfg = self.cfg
        parts = []
        if cfg.frontend:
            parts.append(self._project_frontend(params, batch["frontend_embeds"]))
        if "tokens" in batch and cfg.frontend != "audio":
            parts.append(self._embed_tokens(params, batch["tokens"]))
        if len(parts) == 1:
            return parts[0]
        dtype = torch.promote_types(parts[0].dtype, parts[1].dtype)
        return torch.cat([p.to(dtype) for p in parts], 1)

    def hidden_states(
        self, params: Params, batch: dict[str, torch.Tensor]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward → (hidden (B, S, d), aux_loss)."""
        return self._stack(params, batch)

    def _stack(
        self, params: Params, batch: dict[str, torch.Tensor], states: list | None = None,
        shared: dict | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The forward of :meth:`hidden_states`, Hymba's meta tokens joined
        in front of the input and dropped before the final norm.  ``states``
        (a list) receives each layer's Mamba state and ``shared`` each
        K/V-computing layer's K and V (:func:`.hymba.HymbaConfig.kv_sources`),
        as a prefill that fills a cache needs them."""
        cfg = self.cfg
        hy = hymba.options(cfg)
        x = self._embed_inputs(params, batch)
        if hy.n_meta_tokens:
            meta = params["meta"].to(x.dtype)[None].expand(x.shape[0], -1, -1)
            x = torch.cat([meta, x], 1)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        if shared is None and hy.kv_share:
            if remat:
                raise ValueError("remat would recompute a layer whose K/V another layer reads")
            shared = {}
        sources = hy.kv_sources()
        for i, bp in enumerate(params["blocks"]):
            kv = None if shared is None else shared.setdefault(sources[i], {})
            state = None if states is None else {}
            if remat:
                # A block draws no random numbers, so its recomputation needs
                # no saved RNG state (reading it is refused under graph capture).
                x, da = ckpt.checkpoint(block_apply, bp, x, cfg, i, use_reentrant=False,
                                        preserve_rng_state=False, **_remat_kwargs(cfg))
            else:
                x, da = block_apply(bp, x, cfg, i, kv, state)
            if states is not None:
                states.append(state)
            aux = aux + da
        return norm_apply(params["final_norm"], x[:, hy.n_meta_tokens:], cfg.norm), aux

    def _head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return unembed_apply(params["embed"], h)
        return linear(h, params["lm_head"].to(h.dtype))

    def logits(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        h, _ = self.hidden_states(params, batch)
        return self._head(params, h)

    # -------------------------------------------------------------- loss
    def loss(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Next-token cross entropy + 0.01·aux, as the reference's: labels < 0
        are masked (and clamped to 0).  With ``cfg.loss_chunk`` set and S
        above it, the sequence is padded to whole chunks of ``loss_chunk``
        positions and each chunk takes its full-vocabulary logits in turn
        (the reference's docstring says "vocab-chunked"; its code cuts S)."""
        cfg = self.cfg
        h, aux = self.hidden_states(params, batch)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        labels = labels.clamp_min(0).long()

        def xent(h_slice, labels_slice, mask_slice):
            logits = self._head(params, h_slice).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = gather_last(logits, labels_slice)
            return ((logz - gold) * mask_slice).sum()

        if cfg.loss_chunk and h.shape[1] > cfg.loss_chunk:
            s, chunk = h.shape[1], cfg.loss_chunk
            n_chunks = -(-s // chunk)
            pad = n_chunks * chunk - s
            if pad:
                h = torch.nn.functional.pad(h, (0, 0, 0, pad))
                labels = torch.nn.functional.pad(labels, (0, pad))
                mask = torch.nn.functional.pad(mask, (0, pad))
            total = torch.zeros((), dtype=torch.float32, device=h.device)
            for i in range(n_chunks):  # unrolled, as the reference's
                sl = slice(i * chunk, (i + 1) * chunk)
                total = total + xent(h[:, sl], labels[:, sl], mask[:, sl])
        else:
            total = xent(h, labels, mask)
        return total / mask.sum().clamp_min(1.0) + 0.01 * aux

    # ------------------------------------------------------------- cache
    def init_cache(
        self, batch: int, cache_len: int, dtype: torch.dtype = torch.bfloat16
    ) -> list[Params]:
        """One zeroed decode state per layer, on the model's device: KV
        caches of ``dtype``, bfloat16 by default as in the reference (K/V are
        rounded to it when written and read back to the step's type), and
        the SSM kinds' float32 states.  A Hymba layer that reuses K/V holds
        its partner's K/V cache (the same tensors)."""
        caches = [
            init_block_cache(self.cfg, i, batch, cache_len, dtype, self.device)
            for i in range(self.cfg.n_layers)
        ]
        for i, src in enumerate(hymba.options(self.cfg).kv_sources()):
            if src != i:
                caches[i]["kv"] = caches[src]["kv"]
        return caches

    # ----------------------------------------------------------- prefill
    def prefill(
        self, params: Params, batch: dict[str, torch.Tensor], cache_len: int,
        cache_dtype: torch.dtype = torch.bfloat16,
    ) -> tuple[torch.Tensor, list[Params] | None]:
        """The full prompt's forward → (last position's logits (B, 1, V),
        None): as in the reference, no cache is filled.  A
        :class:`.hymba.HymbaConfig` fills one of ``cache_len`` positions
        (meta tokens included) and ``cache_dtype`` and returns it in None's
        place: the meta tokens' slots, each windowed layer's ring of its
        last positions, every position of a global layer, each Mamba's
        state.  Every row's prompt has the batch's length."""
        if not isinstance(self.cfg, HymbaConfig):
            h, _ = self.hidden_states(params, batch)
            return self._head(params, h[:, -1:]), None
        with torch.no_grad():
            states: list = []
            shared: dict = {}
            h, _ = self._stack(params, batch, states, shared)
            return self._head(params, h[:, -1:]), self._fill_cache(
                h, states, shared, cache_len, cache_dtype)

    def _fill_cache(self, h, states, shared, cache_len, cache_dtype) -> list[Params]:
        """A decode cache from :meth:`_stack`'s Mamba ``states`` and the K/V
        in ``shared``, after a prompt whose hidden states are ``h``."""
        cfg = self.cfg
        p = cfg.n_meta_tokens
        total = p + h.shape[1]
        cache = self.init_cache(h.shape[0], cache_len, cache_dtype)
        for i, (c, st) in enumerate(zip(cache, states)):
            c["mamba"]["h"].copy_(st["h"])
            c["mamba"]["conv"].copy_(st["conv"])
            if i not in shared:
                continue
            slots = c["kv"]["k"].shape[2]
            keep = torch.arange(total, device=h.device)
            if cfg.window(i):  # the meta tokens and the ring's last positions
                keep = keep[(keep < p) | (keep >= max(p, total - (slots - p)))]
            elif total > slots:
                raise ValueError(f"{total} positions do not fit a global layer's {slots} slots")
            at = hymba.slot_of(cfg, i, keep, slots)
            for name in ("k", "v"):
                c["kv"][name][:, :, at] = shared[i][name][:, keep].transpose(1, 2).to(cache_dtype)
        return cache

    # ------------------------------------------------------------ decode
    def decode_step(
        self,
        params: Params,
        tokens: torch.Tensor,
        cache: list[Params],
        pos: int | torch.Tensor,
    ) -> tuple[torch.Tensor, list[Params]]:
        """One token for every row.  tokens: (B, 1) ids, or for audio the
        (B, 1, 512) frame embeddings; ``pos``: the position of every row (an
        int or a 0-d tensor).  Returns (logits (B, 1, V), cache); **the cache
        is updated in place** and returned."""
        cfg = self.cfg
        hy = hymba.options(cfg)
        if cfg.frontend == "audio":
            x = self._project_frontend(params, tokens)
        else:
            x = self._embed_tokens(params, tokens)
        # The slot, the valid length and the rotary tables are the same for
        # every attention layer of a cache length and window: made once per step.
        slots: dict[tuple[int, int], DecodeSlot] = {}
        new_cache = []
        for i, (bp, c) in enumerate(zip(params["blocks"], cache, strict=True)):
            at = pos
            if "kv" in c:
                key = (c["kv"]["k"].shape[2], hy.window(i))
                if key not in slots:
                    slots[key] = decode_slot(
                        pos, x.shape[0], key[0], head_dim=cfg.resolved_head_dim,
                        rope_theta=cfg.rope_theta, sliding_window=key[1],
                        device=x.device, prefix=hy.n_meta_tokens,
                    )
                at = slots[key]
            x, c2 = block_decode(bp, x, c, at, cfg, i)
            new_cache.append(c2)
        x = norm_apply(params["final_norm"], x, cfg.norm)
        return self._head(params, x), new_cache

    def forward(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        return self.logits(params, batch)

    # ------------------------------------------------------------- utils
    @staticmethod
    def param_count(params: Params) -> int:
        def count(p) -> int:
            if isinstance(p, torch.Tensor):
                return p.numel()
            if isinstance(p, dict):
                return sum(count(v) for v in p.values())
            return sum(count(v) for v in p)

        return count(params)
