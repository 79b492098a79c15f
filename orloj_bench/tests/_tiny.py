"""A tiny configuration of each kind of attention, for the CPU tests."""

_ATTN = dict(name="tiny_attn", arch_type="dense", block_pattern="attn", n_layers=2,
             d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=300,
             rope_theta=10000.0, sliding_window=0, dtype="float32")

TINY = {
    "attn": _ATTN,
    "windowed": _ATTN | {"name": "tiny_windowed", "sliding_window": 8},
}
