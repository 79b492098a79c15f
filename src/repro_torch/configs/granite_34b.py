"""Granite-34B-code: llama-architecture dense decoder, MQA (1 KV head).
[arXiv:2405.04324]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    arch_type="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    norm="rmsnorm",
    mlp="swiglu",
    remat=True,
    source="arXiv:2405.04324",
)
