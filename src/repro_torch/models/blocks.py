"""Decoder blocks of the port, as :mod:`repro.models.blocks`: the attention
block with a dense MLP, an MoE layer, or both (Arctic's dense residual
beside the MoE); Hymba's hybrid block (attention ∥ Mamba heads, each
RMS-normed, averaged); and xLSTM's mLSTM and sLSTM blocks.  For the full
sequence (``block_apply``) and for one decode step (``init_block_cache``,
``block_decode``).

A block's cache holds what its kind needs: ``{"kv": …}`` for attention,
``{"kv": …, "mamba": …}`` for Hymba, ``{"cell": …}`` for xLSTM's cells."""

from __future__ import annotations

from typing import Any

import torch

from . import moe as moe_lib
from . import ssm
from .config import ModelConfig
from .sharding import tp_only_layout
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


def block_kind(cfg: ModelConfig, layer_idx: int) -> str:
    if cfg.block_pattern == "xlstm":
        return "slstm" if (layer_idx % cfg.slstm_every) == cfg.slstm_every - 1 else "mlstm"
    if cfg.block_pattern == "hymba":
        return "hymba"
    return "attn"


def init_block(gen: torch.Generator, cfg: ModelConfig, layer_idx: int) -> Params:
    kind = block_kind(cfg, layer_idx)
    d = cfg.d_model
    p: Params = {"norm1": init_norm(gen, d, cfg.norm)}
    if kind == "mlstm":
        p["cell"] = ssm.init_mlstm(gen, d, cfg.n_heads)
        return p
    if kind == "slstm":
        p["cell"] = ssm.init_slstm(gen, d, cfg.n_heads)
        return p
    p["attn"] = init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    if kind == "hymba":
        p["mamba"] = ssm.init_mamba(gen, d, cfg.ssm_state)
        p["norm_attn"] = init_norm(gen, d, "rmsnorm")
        p["norm_ssm"] = init_norm(gen, d, "rmsnorm")
    p["norm2"] = init_norm(gen, d, cfg.norm)
    if cfg.is_moe:
        p["moe"] = moe_lib.init_moe(gen, d, cfg.d_ff, cfg.n_experts)
        if cfg.moe_dense_residual:
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp)
    elif cfg.mlp != "none":
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp)
    return p


def _hymba_mix(params: Params, attn_out: torch.Tensor, ssm_out: torch.Tensor) -> torch.Tensor:
    """0.5·(rmsnorm(attention) + rmsnorm(SSM)), both through the rmsnorm kernel."""
    return 0.5 * (
        norm_apply(params["norm_attn"], attn_out, "rmsnorm")
        + norm_apply(params["norm_ssm"], ssm_out, "rmsnorm")
    )


def block_apply(
    params: Params, x: torch.Tensor, cfg: ModelConfig, layer_idx: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (x, aux_loss); aux is 0 without MoE.
    With ``cfg.fsdp_weight_gather`` the block's DTensor weights first take
    their tensor-parallel-only layout (gathered over ``data``), as the
    reference constrains them."""
    if cfg.fsdp_weight_gather:
        params = tp_only_layout(params)
    kind = block_kind(cfg, layer_idx)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm_apply(params["norm1"], x, cfg.norm)
    # The reference bounds its unrolled carry to <= 32 chunks, growing the chunk.
    chunk = max(cfg.mlstm_chunk, x.shape[1] // 32)
    if kind == "mlstm":
        return x + ssm.mlstm_apply(params["cell"], h, chunk), zero
    if kind == "slstm":
        return x + ssm.slstm_apply(params["cell"], h, cfg.n_heads), zero
    attn_out = attention_apply(
        params["attn"],
        h,
        n_kv=cfg.n_kv_heads,
        rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window,
        softcap=cfg.logit_softcap,
        repeat_kv=cfg.gqa_repeat_kv,
    )
    if kind == "hymba":
        x = x + _hymba_mix(params, attn_out, ssm.mamba_apply(params["mamba"], h, chunk))
    else:
        x = x + attn_out
    x, aux = _ffn(params, x, cfg)
    return x, aux if aux is not None else zero


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
    """The layer's decode state, on the card unless the caller asks for the
    CPU: a KV cache of ``dtype`` (with a sliding window, a ring of
    min(cache_len, window) slots), and for the SSM kinds their float32
    states, whatever ``dtype`` is (as the reference)."""
    kind = block_kind(cfg, layer_idx)
    d = cfg.d_model
    if kind == "mlstm":
        return {"cell": ssm.init_mlstm_cache(batch, d, cfg.n_heads, device=device)}
    if kind == "slstm":
        return {"cell": ssm.init_slstm_cache(batch, d, device=device)}
    eff_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    c: Params = {
        "kv": init_kv_cache(batch, cfg.n_kv_heads, eff_len, cfg.resolved_head_dim, dtype, device)
    }
    if kind == "hymba":
        c["mamba"] = ssm.init_mamba_cache(batch, d, cfg.ssm_state, device=device)
    return c


def block_decode(
    params: Params,
    x: torch.Tensor,
    cache: Params,
    pos: int | torch.Tensor | DecodeSlot,
    cfg: ModelConfig,
    layer_idx: int,
) -> tuple[torch.Tensor, Params]:
    """One-token decode step, x: (B, 1, d); ``pos`` as in
    :func:`.layers.attention_decode` (unused by the xLSTM cells).  The cache
    is updated in place and returned."""
    kind = block_kind(cfg, layer_idx)
    h = norm_apply(params["norm1"], x, cfg.norm)
    if kind == "mlstm":
        out, _ = ssm.mlstm_decode(params["cell"], h, cache["cell"])
        return x + out, cache
    if kind == "slstm":
        out, _ = ssm.slstm_decode(params["cell"], h, cache["cell"], cfg.n_heads)
        return x + out, cache
    attn_out, _ = attention_decode(
        params["attn"],
        h,
        cache["kv"],
        pos,
        n_kv=cfg.n_kv_heads,
        rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window,
        softcap=cfg.logit_softcap,
    )
    if kind == "hymba":
        ssm_out, _ = ssm.mamba_decode(params["mamba"], h, cache["mamba"])
        x = x + _hymba_mix(params, attn_out, ssm_out)
    else:
        x = x + attn_out
    x, _ = _ffn(params, x, cfg)
    return x, cache
