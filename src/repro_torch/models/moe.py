"""Mixture-of-experts layer of the port (DBRX-style fine-grained top-k;
Arctic's dense residual is composed in :mod:`.blocks`).

The counterpart of :mod:`repro.models.moe`, with the same dispatch: the
router's top-k comes from the gating kernel
(:func:`repro_torch.kernels.ops.moe_gating`, which picks the same ids as the
reference's ``lax.top_k``, ties included), and capacity slots come from a
cumulative count,

    slot(token, k) = expert_id · C + (# earlier assignments to expert_id),

in token-major order.  Assignments past the capacity C (rounded up to a
multiple of 8, at least 8) go to a dump row ``E·C`` and are dropped.  The
expert products are dense (E, C, d) × (E, d, f) batched matrix products,
which the reference also computes outside any Pallas kernel.  Every slot
is computed, filled or not, so a forward reads every expert's weights.

Padded rows of a batch are routed like real tokens and take capacity, as
in the reference (ROADMAP §C).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from .layers import _init

Params = dict[str, Any]


def init_moe(gen: torch.Generator, d: int, ff: int, n_experts: int) -> Params:
    return {
        "router": _init(gen, (d, n_experts)),
        "w_gate": _init(gen, (n_experts, d, ff)),
        "w_up": _init(gen, (n_experts, d, ff)),
        "w_down": _init(gen, (n_experts, ff, d), scale=1.0 / math.sqrt(ff)),
    }


def capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = math.ceil(n_tokens * top_k * cf / n_experts)
    return max(8, (c + 7) // 8 * 8)  # a multiple of 8, as the reference pads it


def moe_apply(
    params: Params,
    x: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y, aux_loss).  aux_loss is the Switch load-balance
    loss (E · Σ_e fraction_e · mean_prob_e)."""
    bsz, s, d = x.shape
    dtype = x.dtype
    n_experts = params["router"].shape[1]
    t = bsz * s
    xt = x.reshape(t, d)
    logits = (xt @ params["router"].to(dtype)).float()
    gate_vals, expert_ids = ops.moe_gating(logits, top_k)  # (T, k) each

    # Load-balance loss, from the full softmax (the gating kernel returns
    # only the k gates) and the first choice.  It feeds only the loss.
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(expert_ids[:, 0].long(), n_experts).float().mean(0)
    aux = n_experts * (frac * probs.mean(0)).sum()

    # Capacity slots via cumulative assignment counts, token-major.
    r = t * top_k
    flat_experts = expert_ids.reshape(r).long()
    flat_gates = gate_vals.reshape(r).to(dtype)
    flat_tokens = torch.arange(t, device=x.device).repeat_interleave(top_k)
    onehot = F.one_hot(flat_experts, n_experts)  # (R, E)
    pos_in_e = (onehot.cumsum(0) - onehot).gather(1, flat_experts[:, None])[:, 0]
    cap = capacity(t, top_k, n_experts, capacity_factor)
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_experts * cap + pos_in_e, n_experts * cap)

    # Scatter tokens into an (E·C + 1 dump row, d) buffer.
    buf = torch.zeros((n_experts * cap + 1, d), dtype=dtype, device=x.device)
    buf.index_add_(0, slot, xt[flat_tokens])
    xb = buf[: n_experts * cap].reshape(n_experts, cap, d)

    # Expert FFN (SwiGLU), dense per-expert products.
    g = torch.bmm(xb, params["w_gate"].to(dtype))
    u = torch.bmm(xb, params["w_up"].to(dtype))
    yb = torch.bmm(F.silu(g) * u, params["w_down"].to(dtype))

    # Gather back and combine with the gates.
    yflat = yb.reshape(n_experts * cap, d)
    y_rows = torch.where(keep[:, None], yflat[slot.clamp(max=n_experts * cap - 1)], 0.0)
    y = torch.zeros((t, d), dtype=dtype, device=x.device)
    y.index_add_(0, flat_tokens, y_rows * flat_gates[:, None])
    return y.reshape(bsz, s, d), aux


def moe_ref(params: Params, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Dense oracle: every expert runs on every token (no capacity drops),
    routed by the plain gating.  For tests of the dispatch path."""
    bsz, s, d = x.shape
    dtype = x.dtype
    xt = x.reshape(-1, d)
    logits = (xt @ params["router"].to(dtype)).float()
    gate_vals, expert_ids = ref.moe_gating_ref(logits, top_k)
    g = torch.einsum("td,edf->etf", xt, params["w_gate"].to(dtype))
    u = torch.einsum("td,edf->etf", xt, params["w_up"].to(dtype))
    ye = torch.einsum("etf,efd->etd", F.silu(g) * u, params["w_down"].to(dtype))
    mask = F.one_hot(expert_ids.long(), params["router"].shape[1]).float()
    w = (gate_vals[..., None] * mask).sum(1)  # (T, E)
    y = torch.einsum("te,etd->td", w.to(dtype), ye)
    return y.reshape(bsz, s, d)
