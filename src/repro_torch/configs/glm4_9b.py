"""GLM-4-9B: dense decoder, RoPE, GQA (2 KV heads). [hf:THUDM/glm-4-9b]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    arch_type="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10_000.0,
    loss_chunk=512,
    remat=True,
    source="hf:THUDM/glm-4-9b",
)
