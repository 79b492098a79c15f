"""Decoder blocks of the port: the attention block with a dense MLP, an MoE
layer, or both (Arctic's dense residual beside the MoE), for the full
sequence (``block_apply``) and for one decode step over a KV cache
(``init_block_cache``, ``block_decode``).

The Hymba and xLSTM blocks of :mod:`repro.models.blocks` are not ported
yet (ROADMAP A8) and raise."""

from __future__ import annotations

from typing import Any

import torch

from . import moe as moe_lib
from .config import ModelConfig
from .layers import (
    DecodeSlot,
    attention_apply,
    attention_decode,
    init_attention,
    init_kv_cache,
    init_mlp,
    init_norm,
    mlp_apply,
    norm_apply,
)

Params = dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the config this slice of the port lacks."""
    if cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"{cfg.block_pattern} blocks are not ported yet: ROADMAP A8 (SSM and recurrent cells)"
        )


def init_block(gen: torch.Generator, cfg: ModelConfig, layer_idx: int) -> Params:
    check_supported(cfg)
    d = cfg.d_model
    p: Params = {"norm1": init_norm(gen, d, cfg.norm)}
    p["attn"] = init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    p["norm2"] = init_norm(gen, d, cfg.norm)
    if cfg.is_moe:
        p["moe"] = moe_lib.init_moe(gen, d, cfg.d_ff, cfg.n_experts)
        if cfg.moe_dense_residual:
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp)
    elif cfg.mlp != "none":
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp)
    return p


def block_apply(
    params: Params, x: torch.Tensor, cfg: ModelConfig, layer_idx: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (x, aux_loss); aux is 0 without MoE."""
    check_supported(cfg)
    h = norm_apply(params["norm1"], x, cfg.norm)
    x = x + attention_apply(
        params["attn"],
        h,
        n_kv=cfg.n_kv_heads,
        rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window,
        softcap=cfg.logit_softcap,
        repeat_kv=cfg.gqa_repeat_kv,
    )
    x, aux = _ffn(params, x, cfg)
    return x, aux if aux is not None else torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn(
    params: Params, x: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's second half: the MoE (with Arctic's dense residual) or
    the dense MLP on the normed residual.  Returns (x, the MoE's aux_loss
    or None)."""
    aux = None
    if cfg.is_moe:
        h2 = norm_apply(params["norm2"], x, cfg.norm)
        y, aux = moe_lib.moe_apply(
            params["moe"], h2, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor
        )
        if cfg.moe_dense_residual:
            y = y + mlp_apply(params["mlp"], h2, cfg.mlp)
        x = x + y
    elif cfg.mlp != "none":
        h2 = norm_apply(params["norm2"], x, cfg.norm)
        x = x + mlp_apply(params["mlp"], h2, cfg.mlp)
    return x, aux


# ----------------------------------------------------------------- cache
def init_block_cache(
    cfg: ModelConfig,
    layer_idx: int,
    batch: int,
    cache_len: int,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Params:
    """The layer's KV cache, on the card unless the caller asks for the
    CPU; with a sliding window, a ring of min(cache_len, window) slots."""
    check_supported(cfg)
    eff_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    return {
        "kv": init_kv_cache(batch, cfg.n_kv_heads, eff_len, cfg.resolved_head_dim, dtype, device)
    }


def block_decode(
    params: Params,
    x: torch.Tensor,
    cache: Params,
    pos: int | torch.Tensor | DecodeSlot,
    cfg: ModelConfig,
    layer_idx: int,
) -> tuple[torch.Tensor, Params]:
    """One-token decode step, x: (B, 1, d); ``pos`` as in
    :func:`.layers.attention_decode`.  The cache is updated in place and
    returned."""
    check_supported(cfg)
    h = norm_apply(params["norm1"], x, cfg.norm)
    attn_out, kv = attention_decode(
        params["attn"],
        h,
        cache["kv"],
        pos,
        n_kv=cfg.n_kv_heads,
        rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window,
        softcap=cfg.logit_softcap,
    )
    x, _ = _ffn(params, x + attn_out, cfg)
    return x, {"kv": kv}
