"""Nemotron-4-340B: 96-layer dense decoder, GQA (8 KV), squared-ReLU MLP.
[arXiv:2402.16819]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    norm="layernorm",
    mlp="relu2",
    loss_chunk=256,
    remat=True,
    source="arXiv:2402.16819",
)
