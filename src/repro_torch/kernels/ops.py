"""Public wrappers of the port's kernels.

The device of the input decides the path, and nothing else: a tensor on
the CPU goes to the plain PyTorch version (:mod:`.ref`), which autograd
differentiates; a CUDA tensor launches the hand-written Hopper kernel or
raises.  There is no switch and no fallback from a failed build or launch
to the plain version.

On the card, flash attention, RMSNorm and the gates are differentiable:
when grad mode is on and an input requires grad, the call goes through a
``torch.autograd.Function`` whose forward launches the forward kernel and
whose backward launches the backward kernel.  Otherwise (serving, under
no_grad) the forward kernel alone runs, as it always did.  The decode
kernel has no training use and no backward: its launcher refuses inputs
that require grad.
"""

from __future__ import annotations

import torch

from . import _build
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import moe_gating as _gating
from . import ref
from . import rmsnorm as _rmsnorm

# Each kernel's launch counter: (module, attribute), by the name of its
# library (``_build.KERNELS``).
_COUNTERS = {
    "flash_attention": (_flash, "launches"),
    "decode_attention": (_decode, "launches"),
    "rmsnorm": (_rmsnorm, "launches"),
    "moe_gating": (_gating, "launches"),
    "flash_attention_bwd": (_flash, "backward_launches"),
    "rmsnorm_bwd": (_rmsnorm, "backward_launches"),
    "moe_gating_bwd": (_gating, "backward_launches"),
}


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel for tensors on {t.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, window, softcap):
        out, lse = _flash.flash_attention_cuda(
            q, k, v, lengths, causal=causal, window=window, softcap=softcap, return_lse=True
        )
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        dq, dk, dv = _flash.flash_attention_backward_cuda(
            q, k, v, out, dout, lse, lengths, **ctx.opts
        )
        return dq, dk, dv, None, None, None, None


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm.rmsnorm_cuda(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _rmsnorm.rmsnorm_backward_cuda(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


class _MoEGating(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, top_k):
        gates, ids = _gating.moe_gating_cuda(logits, top_k)
        ctx.save_for_backward(logits, ids)
        ctx.mark_non_differentiable(ids)
        return gates, ids

    @staticmethod
    def backward(ctx, dgates, dids):
        del dids
        logits, ids = ctx.saved_tensors
        return _gating.moe_gating_backward_cuda(logits, ids, dgates), None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd); lengths: (B,) int32 or None
    (every row has S keys); ``softcap > 0`` caps the scaled scores."""
    if _route(q) == "cpu":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, lengths=lengths, window=window, softcap=softcap
        )
    if _build.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, lengths, causal, window, softcap)
    return _flash.flash_attention_cuda(
        q, k, v, lengths, causal=causal, window=window, softcap=softcap
    )


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, KV, S, hd) of q's type, or bfloat16 under
    float32 queries; valid_len: (B,) int32; ``softcap > 0`` caps the scaled
    scores."""
    if _route(q) == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, valid_len, softcap=softcap)
    return _decode.decode_attention_cuda(q, k_cache, v_cache, valid_len, softcap=softcap)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d), flattened to rows; scale: (d,).  The default eps is the
    reference wrapper's (``repro.kernels.ops.rmsnorm``); the models pass
    their own 1e-5."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _route(x) == "cpu":
        out = ref.rmsnorm_ref(x2, scale, eps)
    elif _build.needs_grad(x, scale):
        out = _RMSNorm.apply(x2.contiguous(), scale.float().contiguous(), eps)
    else:
        out = _rmsnorm.rmsnorm_cuda(x2.contiguous(), scale.float().contiguous(), eps=eps)
    return out.reshape(shape)


def moe_gating(logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: (T, E) → (gates (T, k) float32, ids (T, k) int32)."""
    if _route(logits) == "cpu":
        return ref.moe_gating_ref(logits, top_k)
    if _build.needs_grad(logits):
        return _MoEGating.apply(logits.contiguous(), top_k)
    return _gating.moe_gating_cuda(logits.contiguous(), top_k)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by kernel
    (a ``*_bwd`` backward counts once a call, whatever it launches: flash's
    and RMSNorm's launch two kernels each)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
