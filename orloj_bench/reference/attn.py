"""The plain reference of the ``attn`` family: a float32 forward in torch
operations alone, one prompt at a time, layer by layer.

Written from the published description: a decoder of pre-norm blocks, each
RMSNorm → RoPE attention with grouped KV heads (within a sliding window
where the configuration gives one) → residual, RMSNorm → SwiGLU MLP →
residual, then RMSNorm and the LM head (GLM-4, hf:THUDM/glm-4-9b).
Departures, as the configuration's file states what is served: no bias on
the q, k, v projections; RoPE rotates the two halves of the whole head (not
the first half in interleaved pairs); θ = 10,000; RMSNorm's ε = 1e-5; the
embedding is scaled by √d.

No kernel of the program and nothing of it is imported.  TF32 is off
unless ``tf32`` asks for it (the lower-precision control).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

EPS = 1e-5


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products in full float32 (``tf32=False``) or in TF32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, heads, hd), rotated by position, the two halves of each head
    as the two coordinates."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(cfg: dict, w: dict, i: int, h: torch.Tensor) -> torch.Tensor:
    s = h.shape[0]
    nh, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = rope((h @ w["wq"][i]).view(s, nh, hd), cfg["rope_theta"])
    k = rope((h @ w["wk"][i]).view(s, kv, hd), cfg["rope_theta"])
    v = (h @ w["wv"][i]).view(s, kv, hd)
    g = nh // kv  # query head j reads KV head j // g
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    pos = torch.arange(s, device=h.device)
    allowed = pos[None, :] <= pos[:, None]
    if cfg.get("sliding_window", 0) > 0:
        allowed &= pos[None, :] > pos[:, None] - cfg["sliding_window"]
    scores = scores.masked_fill(~allowed, float("-inf"))
    ctx = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return ctx.reshape(s, nh * hd) @ w["wo"][i]


def block(cfg: dict, w: dict, i: int, x: torch.Tensor) -> torch.Tensor:
    x = x + attention(cfg, w, i, rmsnorm(x, w["norm1"][i]))
    h2 = rmsnorm(x, w["norm2"][i])
    return x + (F.silu(h2 @ w["w_gate"][i]) * (h2 @ w["w_up"][i])) @ w["w_down"][i]


@torch.no_grad()
def logits(cfg: dict, w: dict, tokens: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """tokens: (S,) ids → (S, vocab) float32 logits of one prompt."""
    with precision(tf32):
        ids = tokens.to(w["embed"].device).long().clamp(0, cfg["vocab_size"] - 1)
        x = w["embed"][ids].float() * math.sqrt(cfg["d_model"])
        for i in range(cfg["n_layers"]):
            x = block(cfg, w, i, x)
        return rmsnorm(x, w["final_norm"]) @ w["lm_head"]
