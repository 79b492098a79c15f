"""DBRX-base (132B): fine-grained MoE, 16 experts top-4, GQA.
[hf:databricks/dbrx-base]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    norm="layernorm",
    mlp="swiglu",
    n_experts=16,
    top_k=4,
    loss_chunk=512,
    remat=True,
    source="hf:databricks/dbrx-base",
)
