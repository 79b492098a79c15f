"""Snowflake Arctic (480B): 128-expert top-2 residual MoE + dense branch.
[hf:Snowflake/snowflake-arctic-base]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    norm="rmsnorm",
    mlp="swiglu",
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    remat=True,
    source="hf:Snowflake/snowflake-arctic-base",
)
