"""The lower-precision control at the configuration's full size, on the
card: the reference computed with TF32 products, put in the program's
place, fails the check's limits on every seed.  Skips without a card.

    python -m pytest -q -m cuda orloj_bench/tests/test_orloj_bench_control.py
"""

import numpy as np
import pytest
import torch

from orloj_bench import harness, reference, traffic
from orloj_bench.weights import make_weights

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_tf32_control_fails_the_limits(card):
    cell = harness.load_cell("glm4_9b.bimodal.r80")
    limits = cell.checks["limits"]
    for seed in SEEDS:
        stream = traffic.make_stream(cell.traffic, cell.mix, seed, 2_000.0, (32, 64, 128, 256))
        longest = max(stream.prompts, key=len)
        prompts = [longest] + stream.prompts[:5]
        w = make_weights(cell.config, seed, card)
        worst = {k: 0.0 for k in limits}
        for p in prompts:
            tokens = torch.from_numpy(np.asarray(p))
            ref = reference.logits(cell.config, w, tokens)
            low = reference.logits(cell.config, w, tokens, tf32=True)
            r = harness.readings(ref, low)
            worst = {k: max(worst[k], r[k]) for k in limits}
        del w
        torch.cuda.empty_cache()
        assert any(worst[k] > limits[k] for k in limits), (seed, worst, limits)
