"""``work.py`` against counts made by hand at a tiny configuration."""

import pytest
import torch

from orloj_bench import work
from orloj_bench.tests._tiny import TINY


def test_flash_pairs_and_bytes_by_hand():
    q = torch.empty((2, 4, 4, 16), device="meta")
    k = torch.empty((2, 2, 4, 16), device="meta")
    nbytes, flops = work.flash_work(q, k, None, True, 0)
    assert flops == 4 * 16 * (1 + 2 + 3 + 4) * 4 * 2  # causal pairs × heads × rows
    assert nbytes == 4 * (2 * 2 * 4 * 4 * 16 + 2 * 2 * 2 * 4 * 16)
    _, windowed = work.flash_work(q, k, None, True, 2)
    assert windowed == 4 * 16 * (1 + 2 + 2 + 2) * 4 * 2


def test_attention_block_flops_by_hand():
    c = TINY["attn"]
    d, ff, v = 64, 96, 300
    per_layer = 2 * d * (4 + 2 * 2) * 16 + 2 * 4 * 16 * d + 6 * d * ff
    assert work.linear_flops_per_token(c) == 2 * per_layer + 2 * d * v
    k, s = 3, 8
    attn = 4 * 16 * (s * (s + 1) // 2) * 4 * k
    assert work.batch_flops(c, k, s) == k * s * (2 * per_layer + 2 * d * v) + 2 * attn


def test_flash_bound_is_the_larger_of_its_two():
    c = TINY["attn"]
    nbytes, flops = work.flash_layer_work(c, 8, 256)
    assert work.flash_bound_s(c, 8, 256) == pytest.approx(
        max(flops / 495e12, nbytes / 3.35e12))


def test_published_sizes_count_as_expected():
    from orloj_bench import traffic

    c = traffic.load("configs", "glm4_9b")
    # GLM-4-9B: ~9.4 B parameters, two FLOPs each a token.
    assert work.linear_flops_per_token(c) == pytest.approx(17.6e9, rel=0.03)
