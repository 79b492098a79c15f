"""InternVL2-1B: InternViT vision encoder (stub frontend; 256 patch
embeddings supplied by input_specs) + Qwen2-0.5B-style LM backbone.
[arXiv:2404.16821]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    norm="rmsnorm",
    mlp="swiglu",
    frontend="vision",
    n_frontend_tokens=256,
    loss_chunk=512,
    source="arXiv:2404.16821",
)
