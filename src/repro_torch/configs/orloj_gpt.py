"""Paper-scale example model (~100M): the kind of dynamic NLP model ORLOJ
serves (GPT/BART class, Table 1).  Used by the end-to-end examples, the
real-execution serving engine, and the engine-substrate eval tier
(``repro.eval.substrate`` registers it as ``orloj_gpt``, served at
``CONFIG.reduced()`` toy sizes so engine cells run on CPU)."""
from ..models.config import ModelConfig

# Bucket/batch grid the serving examples and the paper-size engine profile
# serve this model with (one compiled program per (bucket, batch) shape).
SERVE_BUCKETS = (32, 64, 128, 256)
SERVE_BATCH_SIZES = (1, 2, 4, 8)

CONFIG = ModelConfig(
    name="orloj-gpt",
    arch_type="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=32000,
    norm="layernorm",
    mlp="gelu",
    source="paper Table 1 (GPT-class)",
)
