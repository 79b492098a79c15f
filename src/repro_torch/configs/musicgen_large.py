"""MusicGen-large: decoder-only LM over EnCodec audio tokens.
The EnCodec frontend is a stub (input_specs supplies frame embeddings);
the 48-layer transformer backbone is fully implemented. [arXiv:2306.05284]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    norm="layernorm",
    mlp="gelu",
    frontend="audio",
    source="arXiv:2306.05284",
)
