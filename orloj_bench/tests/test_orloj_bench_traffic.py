"""The arrival stream: one schedule for every seed (lengths, gaps and their
order from the mix's base seed), other tokens for another seed, and a
shorter window served a prefix of the same schedule."""

import numpy as np
import pytest

from orloj_bench import traffic

BUCKETS = (32, 64, 128, 256)


def _stream(mix: str, seed: int):
    tr = {"mix": mix, "rate_rps": 10.0, "slo_ms": 300.0}
    return traffic.make_stream(tr, traffic.load("mixes", mix), seed, 20_000.0, BUCKETS)


@pytest.mark.parametrize("mix", ["bimodal", "static"])
def test_one_seed_gives_the_same_stream(mix):
    a, b = _stream(mix, 2**31 + 5), _stream(mix, 2**31 + 5)
    assert np.array_equal(a.release_ms, b.release_ms)
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))
    assert a.apps == b.apps


@pytest.mark.parametrize("mix", ["bimodal", "static"])
def test_seeds_change_the_tokens_not_the_schedule(mix):
    a, b = _stream(mix, 1), _stream(mix, 2)
    assert np.array_equal(a.release_ms, b.release_ms)
    assert [len(p) for p in a.prompts] == [len(p) for p in b.prompts]
    assert a.apps == b.apps
    assert any(not np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))
    for k in a.warm:
        assert np.array_equal(a.warm[k], b.warm[k])


def test_poisson_gaps_at_the_rate():
    s = _stream("bimodal", 1)
    gaps = np.diff(s.release_ms, prepend=0.0)
    assert np.mean(gaps) == pytest.approx(100.0, rel=0.05)  # 10 requests a second
    assert np.std(gaps) == pytest.approx(100.0, rel=0.1)  # exponential: std = mean


def test_stream_covers_the_window_and_fits_the_buckets():
    s = _stream("bimodal", 3)
    assert s.release_ms[-1] > 20_000.0
    lens = np.array([len(p) for p in s.prompts])
    assert lens.min() >= 4 and lens.max() <= 256
    assert 0.6 < np.mean(lens < 120) < 0.8  # the 70/30 mixture
    assert all(p.min() >= 1 and p.max() < 1000 for p in s.prompts)


def test_static_mix_is_one_bucket():
    s = _stream("static", 4)
    assert {traffic.bucket_of(len(p), BUCKETS) for p in s.prompts} == {128}


@pytest.mark.parametrize("seconds", [1.0, 20.0])
def test_a_shorter_window_serves_the_same_schedule(seconds):
    tr = {"mix": "bimodal", "rate_rps": 10.0, "slo_ms": 300.0}
    mix = traffic.load("mixes", "bimodal")
    full = traffic.make_stream(tr, mix, 7, traffic.SCHEDULE_MS, BUCKETS)
    short = traffic.make_stream(tr, mix, 7, seconds * 1e3, BUCKETS)
    assert np.array_equal(full.release_ms, short.release_ms)
    assert all(np.array_equal(x, y) for x, y in zip(full.prompts, short.prompts))
