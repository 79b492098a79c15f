"""The plain reference of the ``hymba`` family: a float32 forward in torch
operations alone, one prompt at a time, layer by layer.

Written from the published description of Hymba (arXiv:2411.13676,
hf:nvidia/Hymba-1.5B-Base): the configuration's ``n_meta_tokens`` learned
embeddings are joined in front of the prompt and take the first positions;
every layer runs attention heads and a Mamba on the same RMS-normed input,
RMS-norms each branch's output and averages them, then a SwiGLU MLP, both
with residuals; then RMSNorm and the head tied to the embedding table.
Attention is RoPE attention with grouped KV heads, causal, within the
layer's sliding window except on ``global_layers``, with the meta tokens
visible to every query; ``kv_share`` pairs consecutive windowed layers, the
second attending with the first's K and V.  The Mamba (inner width
``ssm_expand``·d, state ``ssm_state``, a causal depthwise convolution of
``conv_width``, Δ of rank ``dt_rank``) is the recurrence
h_t = exp(−exp(a_log)·Δ_t)·h_{t−1} + Δ_t·x_t·B_t, y_t = (C_t·h_t + D·x_t)·silu(z_t),
stepped one position at a time.  The configuration's ``departures`` list
where this differs from the released model.

No kernel of the program and nothing of it is imported.  TF32 is off
unless ``tf32`` asks for it (the lower-precision control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .attn import precision, rmsnorm, rope


def windows(cfg: dict) -> list[int]:
    """Each layer's sliding window (0: every earlier position)."""
    return [0 if i in cfg["global_layers"] else cfg["sliding_window"] for i in range(cfg["n_layers"])]


def kv_sources(cfg: dict) -> list[int]:
    """Each layer's K/V source: itself, or the first of its pair of
    consecutive windowed layers where the configuration shares K/V."""
    win, src = windows(cfg), []
    for i in range(cfg["n_layers"]):
        pair = cfg["kv_share"] and i > 0 and win[i] > 0 and win[i - 1] > 0 and src[i - 1] == i - 1
        src.append(i - 1 if pair else i)
    return src


def producers(cfg: dict) -> list[int]:
    """The layers that compute K and V, in order (the rows of ``wk``/``wv``)."""
    return [i for i, s in enumerate(kv_sources(cfg)) if s == i]


def mask(s: int, window: int, prefix: int, device) -> torch.Tensor:
    """(S, S) keys each query sees: causal, within the window where there is
    one, and the first ``prefix`` positions always."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    seen = j <= i
    if window > 0:
        seen &= (j > i - window) | (j < prefix)
    return seen


def attention(cfg: dict, w: dict, i: int, h: torch.Tensor, kv: dict) -> torch.Tensor:
    s = h.shape[0]
    nh, nkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = rope((h @ w["wq"][i]).view(s, nh, hd), cfg["rope_theta"])
    src = kv_sources(cfg)[i]
    if src == i:
        row = producers(cfg).index(i)
        kv[i] = (rope((h @ w["wk"][row]).view(s, nkv, hd), cfg["rope_theta"]),
                 (h @ w["wv"][row]).view(s, nkv, hd))
    k, v = (t.repeat_interleave(nh // nkv, dim=1) for t in kv[src])
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    seen = mask(s, windows(cfg)[i], cfg["n_meta_tokens"], h.device)
    scores = scores.masked_fill(~seen, float("-inf"))
    ctx = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return ctx.reshape(s, nh * hd) @ w["wo"][i]


def mamba(cfg: dict, w: dict, i: int, h: torch.Tensor) -> torch.Tensor:
    s = h.shape[0]
    xb = h @ w["in_x"][i]  # (S, E)
    z = h @ w["in_z"][i]
    conv = w["conv"][i]  # (width, E): tap j reads position t − (width − 1) + j
    width = conv.shape[0]
    padded = torch.cat([xb.new_zeros(width - 1, xb.shape[1]), xb])
    xc = F.silu(sum(padded[j : j + s] * conv[j] for j in range(width)))
    dt = F.softplus(xc @ w["w_dt_lo"][i] @ w["w_dt_hi"][i] + w["dt_bias"][i])  # (S, E)
    bm, cm = xc @ w["w_b"][i], xc @ w["w_c"][i]  # (S, N)
    decay = torch.exp(-torch.exp(w["a_log"][i])[None] * dt[:, :, None])  # (S, E, N)
    drive = (dt * xc)[:, :, None] * bm[:, None, :]
    states = torch.empty_like(decay)
    state = torch.zeros_like(decay[0])
    for t in range(s):  # one position at a time
        state = torch.addcmul(drive[t], decay[t], state, out=states[t])
    y = torch.einsum("sen,sn->se", states, cm) + w["d_skip"][i] * xc
    return (y * F.silu(z)) @ w["out"][i]


def block(cfg: dict, w: dict, i: int, x: torch.Tensor, kv: dict) -> torch.Tensor:
    h = rmsnorm(x, w["norm1"][i])
    mixed = 0.5 * (rmsnorm(attention(cfg, w, i, h, kv), w["norm_attn"][i])
                   + rmsnorm(mamba(cfg, w, i, h), w["norm_ssm"][i]))
    x = x + mixed
    h2 = rmsnorm(x, w["norm2"][i])
    return x + (F.silu(h2 @ w["w_gate"][i]) * (h2 @ w["w_up"][i])) @ w["w_down"][i]


@torch.no_grad()
def logits(cfg: dict, w: dict, tokens: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """tokens: (S,) ids → (S, vocab) float32 logits of one prompt."""
    with precision(tf32):
        ids = tokens.to(w["embed"].device).long().clamp(0, cfg["vocab_size"] - 1)
        x = torch.cat([w["meta"], w["embed"][ids] * math.sqrt(cfg["d_model"])])
        kv: dict = {}
        for i in range(cfg["n_layers"]):
            x = block(cfg, w, i, x, kv)
        return rmsnorm(x[cfg["n_meta_tokens"]:], w["final_norm"]) @ w["embed"].T
