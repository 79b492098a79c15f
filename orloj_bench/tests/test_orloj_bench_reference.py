"""The plain reference against the program's forward at a tiny size on the
CPU, on the benchmark's own weights, and the weights in the program's own
layout."""

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


@pytest.mark.parametrize("kind", ["attn", "windowed"])
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


@pytest.mark.parametrize("kind", ["attn", "windowed"])
@pytest.mark.parametrize("seq", [1, 7, 20])
def test_reference_matches_the_program(kind, seq):
    from repro_torch.models import Model

    cfg = TINY[kind]
    w = make_weights(cfg, 4, "cpu")
    model = Model(harness.model_config(cfg), device="cpu")
    tokens = torch.randint(1, 299, (3, seq), generator=torch.Generator().manual_seed(seq))
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
