"""xLSTM-1.3B: 48 blocks, mLSTM (matrix memory, chunkwise-parallel) with
every 8th block an sLSTM (scalar memory, sequential recurrence); no FFN
(d_ff = 0).  [arXiv:2405.04517]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="layernorm",
    mlp="none",
    block_pattern="xlstm",
    slstm_every=8,
    source="arXiv:2405.04517",
)
