"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of one served padded batch, computed from the configuration's shapes.

``flash_work`` is chip_smoke's count, copied: q, k, v read once and the
output written once, and 4·hd FLOPs for each (query, key) pair the masks
let through (q·k and p·v).  The rest counts the products of each model's
layers per token: the projections and the MLP of an attention block, and
the LM head, at two FLOPs a multiply-add.  Elementwise work (norms, RoPE, activations) is not counted:
the step's share of the peak is a share of the tensor work.
"""

from __future__ import annotations

# One NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).  The
# configurations compute in float32: a float32-accurate product runs outside
# the tensor cores (67 TFLOP/s) or as three TF32 passes, so work counted once
# against the TF32 rate bounds every correct implementation below 100%.
TF32_FLOP_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12


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
    kernel's (B, heads, S, hd) layout and the configuration's float32."""
    import torch

    hd = cfg["head_dim"]
    q = torch.empty((k, cfg["n_heads"], s, hd), device="meta", dtype=torch.float32)
    kk = torch.empty((k, cfg["n_kv_heads"], s, hd), device="meta", dtype=torch.float32)
    return q, kk


def flash_layer_work(cfg: dict, k: int, s: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one layer's flash forward at a padded (k, s) batch:
    every row runs the whole bucket, causal, within the window."""
    q, kk = attention_shapes(cfg, k, s)
    return flash_work(q, kk, None, True, cfg.get("sliding_window", 0))


def flash_bound_s(cfg: dict, k: int, s: int) -> float:
    """Least seconds of one layer's flash forward: the larger of its FLOPs at
    the TF32 rate (counted once) and its bytes at HBM bandwidth."""
    nbytes, flops = flash_layer_work(cfg, k, s)
    return max(flops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def linear_flops_per_token(cfg: dict) -> int:
    """FLOPs of one token through every layer's products and the LM head."""
    d, ff, hd = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    h, kv = cfg["n_heads"], cfg["n_kv_heads"]
    attn = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    mlp = 3 * 2 * d * ff
    return cfg["n_layers"] * (attn + mlp) + 2 * d * cfg["vocab_size"]


def batch_flops(cfg: dict, k: int, s: int) -> int:
    """FLOPs of one served padded (k, s) batch: every padded position runs
    the whole model, head included, as the card computes it."""
    _, attn = flash_layer_work(cfg, k, s)
    return k * s * linear_flops_per_token(cfg) + cfg["n_layers"] * attn
