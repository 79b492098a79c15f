"""Decoder blocks of the port: the attention block with a dense MLP, an MoE
layer, or both (Arctic's dense residual beside the MoE).

The Hymba and xLSTM blocks of :mod:`repro.models.blocks` are not ported
yet (ROADMAP A8) and raise."""

from __future__ import annotations

from typing import Any

import torch

from . import moe as moe_lib
from .config import ModelConfig
from .layers import attention_apply, init_attention, init_mlp, init_norm, mlp_apply, norm_apply

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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
