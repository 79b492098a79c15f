"""OLMo-1B: dense decoder with non-parametric LayerNorm, tied embeddings.
[arXiv:2402.00838]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_ln",
    mlp="swiglu",
    tie_embeddings=True,
    source="arXiv:2402.00838",
)
