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
from . import ref


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
) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd); lengths: (B,) int32 or None
    (every row has S keys)."""
    if _route(q) == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, lengths=lengths, window=window)
    return _flash.flash_attention_cuda(q, k, v, lengths, causal=causal, window=window)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, KV, S, hd); valid_len: (B,) int32."""
    if _route(q) == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, valid_len)
    return _decode.decode_attention_cuda(q, k_cache, v_cache, valid_len)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"flash_attention": _flash.launches, "decode_attention": _decode.launches}


def reset_launch_counts() -> None:
    _flash.launches = 0
    _decode.launches = 0
