"""Model configuration: one dataclass covering all assigned arch families."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 → d_model // n_heads

    # Attention
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 → full attention; >0 → ring-buffer window
    causal: bool = True

    # Norm / MLP family
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    mlp: str = "swiglu"  # swiglu | gelu | relu2 | none
    logit_softcap: float = 0.0

    # Mixture-of-experts
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # Arctic: dense FFN + parallel MoE
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    block_pattern: str = "attn"  # attn | hymba | xlstm
    slstm_every: int = 8  # xLSTM: every n-th block is an sLSTM block
    mlstm_chunk: int = 256  # chunkwise-parallel mLSTM chunk length

    # Modality frontend stub (§carve-out: embeddings provided externally)
    frontend: str = ""  # "" | vision | audio
    n_frontend_tokens: int = 0

    # GQA formulation: False = grouped (b,kv,g,s,t) einsums (baseline);
    # True = broadcast KV to all query heads first, so every attention
    # tensor is sharded on the head axis and GSPMD never reshards
    # (§Perf pair 2 — fixes the involuntary-remat warnings for kv < mesh).
    gqa_repeat_kv: bool = False
    # Numerics / structure
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    tie_embeddings: bool = False
    scan_layers: bool = True
    remat: bool = False
    # 'nothing' = recompute the whole block in backward (min memory);
    # 'dots'    = save matmul outputs (less recompute traffic; §Perf pair 2)
    remat_policy: str = "nothing"
    # FSDP fix (§Perf pair 2): constrain layer weights to their TP-only
    # layout inside the block so GSPMD all-gathers the (small) weights
    # over `data` instead of partial-summing the (huge) activations.
    fsdp_weight_gather: bool = False
    loss_chunk: int = 0  # 0 → unchunked; else ceil-chunk seq for the loss
    # Reference/citation for the config (model card or paper).
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def uses_attention(self) -> bool:
        return self.block_pattern in ("attn", "hymba")

    @property
    def n_params_estimate(self) -> int:
        """Rough parameter count (embeddings + blocks), for roofline math."""
        d, ff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.mlp == "swiglu":
            mlp = 3 * d * ff
        elif self.mlp == "none":
            mlp = 0
        else:
            mlp = 2 * d * ff
        per_layer = 0
        if self.block_pattern == "xlstm":
            # mLSTM: qkv + gates + out; treated as ~4 d², no FFN
            per_layer = 5 * d * d
        else:
            per_layer = attn
            if self.block_pattern == "hymba":
                per_layer += 4 * d * d + d * 2 * self.ssm_state  # mamba branch
            if self.is_moe:
                per_layer += self.n_experts * 3 * d * ff
                if self.moe_dense_residual:
                    per_layer += mlp
            else:
                per_layer += mlp
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed

    @property
    def n_active_params_estimate(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params_estimate
        d, ff = self.d_model, self.d_ff
        full = self.n_params_estimate
        moe_all = self.n_layers * self.n_experts * 3 * d * ff
        moe_active = self.n_layers * self.top_k * 3 * d * ff
        return full - moe_all + moe_active

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            mlstm_chunk=32,
            slstm_every=2,
            scan_layers=False,
            remat=False,
            dtype="float32",
            name=self.name + "-smoke",
        )
        # keep kv | heads divisibility
        if small["n_heads"] % small["n_kv_heads"]:
            small["n_kv_heads"] = 1
        small.update(overrides)
        return dataclasses.replace(self, **small)
