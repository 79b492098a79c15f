"""Hymba-1.5B: hybrid blocks with parallel attention + Mamba heads,
sliding-window attention, SSM state 16.  (Meta tokens are not modelled;
see DESIGN.md.)  [arXiv:2411.13676]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    norm="rmsnorm",
    mlp="swiglu",
    block_pattern="hymba",
    ssm_state=16,
    sliding_window=1024,
    source="arXiv:2411.13676",
)
