"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of one served padded batch, computed from the configuration's shapes.

``flash_work`` is chip_smoke's count, copied: q, k, v read once and the
output written once, and 4·hd FLOPs for each (query, key) pair the masks
let through (q·k and p·v).  ``gemm_product_bound_s`` bounds one weight
product.  Both take the element size and the peak rate from the
configuration's ``dtype`` (``DTYPES``).  What a batch holds (its products,
its attention layers and their windows) is the family's
(``families/<block_pattern>.py``): ``batch_flops``, ``flash_bound_s``,
``gemm_products`` and ``gemm_bound_s`` ask it.  Products count at two FLOPs
a multiply-add; elementwise work (norms, RoPE, activations) is not counted:
the step's share of the peak is a share of the tensor work.
"""

from __future__ import annotations

from . import families

# One NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).  A
# float32 configuration's float32-accurate product runs outside the tensor
# cores (67 TFLOP/s) or as three TF32 passes, so work counted once against
# the TF32 rate bounds every correct implementation below 100%; a bfloat16,
# float16 or float8 configuration's products are held to its own type's rate.
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
FP8_FLOP_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12

# A configuration's ``dtype`` (a torch type's name) → (bytes an element, the
# dense rate that bounds its products counted once).
DTYPES = {
    "float32": (4, TF32_FLOP_PER_S),
    "bfloat16": (2, BF16_FLOP_PER_S),
    "float16": (2, BF16_FLOP_PER_S),
    "float8_e4m3fn": (1, FP8_FLOP_PER_S),
}


def dtype_of(cfg: dict) -> tuple[int, float]:
    """(bytes an element, peak FLOP/s) of the configuration's ``dtype``."""
    if cfg["dtype"] not in DTYPES:
        raise ValueError(f"dtype {cfg['dtype']!r} has no peak in work.DTYPES ({', '.join(DTYPES)})")
    return DTYPES[cfg["dtype"]]


def flash_work(q, k, lengths, causal: bool, window: int) -> tuple[int, int]:
    """(bytes, FLOPs) of flash attention on these inputs: q, k, v read once
    and the output written once, and 4·hd FLOPs for each (query, key) pair
    the masks let through (q·k and p·v)."""
    import torch

    b, h, s, hd = q.shape
    kv = k.shape[1]
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    lens = torch.full((b,), s) if lengths is None else lengths.cpu().clamp(0, s)
    pairs = sum(int(mask[:, : int(L)].sum()) for L in lens) * h
    elt = q.element_size()
    nbytes = elt * (2 * b * h * s * hd + 2 * b * kv * s * hd) + (0 if lengths is None else 4 * b)
    return nbytes, 4 * hd * pairs


def attention_shapes(cfg: dict, k: int, s: int) -> tuple:
    """Meta tensors of one layer's q and k at a padded (k, s) batch, in the
    kernel's (B, heads, S, hd) layout and the configuration's ``dtype``."""
    import torch

    hd, dtype = cfg["head_dim"], getattr(torch, cfg["dtype"])
    q = torch.empty((k, cfg["n_heads"], s, hd), device="meta", dtype=dtype)
    kk = torch.empty((k, cfg["n_kv_heads"], s, hd), device="meta", dtype=dtype)
    return q, kk


def flash_layer_work(cfg: dict, k: int, s: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one layer's flash forward at a padded (k, s) batch:
    every row runs the whole bucket, causal, within the window."""
    q, kk = attention_shapes(cfg, k, s)
    return flash_work(q, kk, None, True, cfg.get("sliding_window", 0))


def flash_layer_bound_s(cfg: dict, k: int, s: int) -> float:
    """Least seconds of one layer's flash forward: the larger of its FLOPs at
    the dtype's peak (counted once) and its bytes at HBM bandwidth."""
    nbytes, flops = flash_layer_work(cfg, k, s)
    return max(flops / dtype_of(cfg)[1], nbytes / HBM_BYTES_PER_S)


def gemm_product_bound_s(cfg: dict, m: int, k: int, n: int) -> float:
    """Least seconds of one (M, K) x (K, N) product in the configuration's
    dtype: the larger of its FLOPs at the dtype's peak (counted once,
    whatever passes or splits the kernel makes) and its bytes (both inputs
    read once, the output written once) at HBM bandwidth."""
    elt, peak = dtype_of(cfg)
    return max(2 * m * k * n / peak, elt * (k * n + m * k + m * n) / HBM_BYTES_PER_S)


def batch_flops(cfg: dict, k: int, s: int) -> int:
    """FLOPs of one served padded (k, s) batch, by the configuration's family."""
    return families.of(cfg).batch_flops(cfg, k, s)


def flash_bound_s(cfg: dict, k: int, s: int) -> float:
    """Least seconds of one served padded (k, s) batch's flash forwards over
    all its attention layers, by the configuration's family."""
    return families.of(cfg).flash_bound_s(cfg, k, s)


def gemm_products(cfg: dict, k: int, s: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of every weight product of one served padded (k, s) batch,
    by the configuration's family."""
    return families.of(cfg).gemm_products(cfg, k, s)


def gemm_bound_s(cfg: dict, k: int, s: int) -> float:
    """Least seconds of one served padded (k, s) batch's weight products."""
    return sum(gemm_product_bound_s(cfg, *p) for p in gemm_products(cfg, k, s))
