"""Public wrappers of the port's kernels.

The device of the input decides the path, and nothing else: a tensor on
the CPU goes to the plain PyTorch version (:mod:`.ref`), a CUDA tensor
launches the hand-written Hopper kernel or raises.  There is no switch and
no fallback from a failed build or launch to the plain version.
"""

from __future__ import annotations

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import moe_gating as _gating
from . import ref
from . import rmsnorm as _rmsnorm

_KERNELS = {
    "flash_attention": _flash,
    "decode_attention": _decode,
    "rmsnorm": _rmsnorm,
    "moe_gating": _gating,
}


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel for tensors on {t.device}")


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
    else:
        out = _rmsnorm.rmsnorm_cuda(x2.contiguous(), scale.float().contiguous(), eps=eps)
    return out.reshape(shape)


def moe_gating(logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: (T, E) → (gates (T, k) float32, ids (T, k) int32)."""
    if _route(logits) == "cpu":
        return ref.moe_gating_ref(logits, top_k)
    return _gating.moe_gating_cuda(logits.contiguous(), top_k)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
