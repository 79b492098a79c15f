"""The plain reference against the program's forward at a tiny size on the
CPU, on the benchmark's own weights, and the weights in the program's own
layout: for every tiny configuration file.  And the parts of GLM-4-9B's
family that must not move: its ``ModelConfig`` and its drawn weights."""

import hashlib

import pytest
import torch

from orloj_bench import harness, reference
from orloj_bench.tests._tiny import TINY
from orloj_bench.weights import make_weights, port_params


def _shapes(t):
    if isinstance(t, torch.Tensor):
        return tuple(t.shape)
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    return [_shapes(v) for v in t]


@pytest.mark.parametrize("kind", sorted(TINY))
def test_weights_take_the_programs_layout(kind):
    from repro_torch.models import Model

    cfg = TINY[kind]
    model = Model(harness.model_config(cfg), device="cpu")
    own = model.init(torch.Generator().manual_seed(0))
    assert _shapes(port_params(cfg, make_weights(cfg, 1, "cpu"))) == _shapes(own)


def test_weights_repeat_for_a_seed_in_place_too():
    cfg = TINY["attn"]
    a, b = make_weights(cfg, 2**31 + 9, "cpu"), make_weights(cfg, 3, "cpu")
    assert not torch.equal(a["wq"], b["wq"])
    make_weights(cfg, 2**31 + 9, "cpu", out=b)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kind", sorted(TINY))
@pytest.mark.parametrize("seq", [1, 7, 20])
def test_reference_matches_the_program(kind, seq):
    from repro_torch.models import Model

    cfg = TINY[kind]
    w = make_weights(cfg, 4, "cpu")
    model = Model(harness.model_config(cfg), device="cpu")
    tokens = torch.randint(1, cfg["vocab_size"] - 1, (3, seq),
                           generator=torch.Generator().manual_seed(seq))
    with torch.no_grad():
        got = model.logits(port_params(cfg, w), {"tokens": tokens})
    for b in range(3):
        ref = reference.logits(cfg, w, tokens[b])
        r = harness.readings(ref, got[b])
        assert r["logit_err"] < 1e-5 and r["top_gap"] == 0.0, r


def test_readings_see_a_changed_answer():
    ref = torch.randn(5, 50, generator=torch.Generator().manual_seed(0))
    got = ref.clone()
    assert harness.readings(ref, got) == {"top_gap": 0.0, "logit_err": 0.0}
    got[3, ref[3].argmin()] += 100.0
    r = harness.readings(ref, got)
    assert r["top_gap"] > 1.0 and r["logit_err"] > 10.0


# sha256 of each leaf's bytes, drawn on the CPU from seed 2**31 + 9 for the
# tiny attn file by the draw before the families were split out.
TINY_ATTN_SHA256 = {
    "embed": "93ab2872472bb579", "final_norm": "7e779abf6f36c5cd", "lm_head": "eff42683243ad601",
    "norm1": "3f90dc51032087c0", "norm2": "4adcccc5651a77a1", "wq": "2540dc9df367713a",
    "wk": "3f05d42e24808ed2", "wv": "69a11376977e144c", "wo": "b593ba00bf0e9632",
    "w_gate": "975f9d8fccb38612", "w_up": "7c4dadc6195672a2", "w_down": "1a9c54fd966d4854",
}


def test_the_tiny_attn_weights_are_drawn_as_before():
    w = make_weights(TINY["attn"], 2**31 + 9, "cpu")
    assert list(w) == list(TINY_ATTN_SHA256)
    got = {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()[:16] for k, v in w.items()}
    assert got == TINY_ATTN_SHA256


def test_glm4_9b_model_config_is_built_as_before():
    import dataclasses

    from orloj_bench import traffic
    from repro_torch.models import ModelConfig

    cfg = traffic.load("configs", "glm4_9b")
    before = ModelConfig(
        name="glm4_9b", arch_type="dense", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=151552, head_dim=128, rope_theta=10000.0, sliding_window=0,
        norm="rmsnorm", mlp="swiglu", block_pattern="attn", dtype="float32",
        param_dtype="float32", remat=False)
    got = harness.model_config(cfg)
    assert type(got) is ModelConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(before)
