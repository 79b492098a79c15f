"""Hymba-1.5B's files: its cell loads with its served shapes, its mix, the
family's counts against counts made by hand (each layer's own window with
the meta tokens, no k/v products on a layer that reuses them, the tied
head outside the GEMM's products, the scans' bytes), the scan's roofline
reader, and, on the card, the TF32 control failing the cell's limits at
full size."""

import types
from collections import Counter

import numpy as np
import pytest
import torch

from orloj_bench import families, harness, reference, traffic, work
from orloj_bench.reference import hymba as ref_hymba
from orloj_bench.tests._tiny import TINY
from orloj_bench.trace import Trace
from orloj_bench.weights import make_weights

CELL = "hymba_1_5b.chatdoc.over"


def _published():
    return traffic.load("configs", "hymba_1_5b")


def test_the_cell_loads_with_its_served_shapes():
    cell = harness.load_cell(CELL)
    engine = harness.engine_config(cell.config)
    assert engine.buckets == (256, 512, 1024, 2048) and engine.batch_sizes == (1, 2, 4, 8)
    assert cell.traffic["mix"] == "chatdoc" and cell.mix == traffic.load("mixes", "chatdoc")
    assert {m["name"] for m in cell.end_to_end} == {"goodput_tok_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "ssm_scan_roofline", "gemm_roofline.hymba", "step_mfu.hymba", "eq3_err.hymba",
        "device_idle.hymba", "finish_rate.hymba", "latency_p95_ms.hymba"}


def test_the_chatdoc_mix_is_chats_and_documents_in_one_queue():
    mix = traffic.load("mixes", "chatdoc")
    tr = {"mix": "chatdoc", "rate_rps": 5.0, "slo_ms": 3000.0}
    s = traffic.make_stream(tr, mix, 2**31 + 3, 20_000.0, (256, 512, 1024, 2048))
    lens = np.array([len(p) for p in s.prompts])
    assert lens.min() >= 16 and lens.max() <= 2048
    assert 0.55 < np.mean(lens < 700) < 0.65  # 60% chats
    assert np.mean(lens > 1024) > 0.25  # documents past the window
    assert set(s.apps) == {"short", "long"}


def test_the_published_products_by_hand():
    c = _published()
    k, s = 2, 512
    m = k * (128 + s)
    products = families.of(c).gemm_products(c, k, s)
    # 18 layers compute K/V (14 products), 14 reuse them (12).
    assert len(products) == 18 * 14 + 14 * 12 == 420
    assert {p[0] for p in products} == {m}
    counts = Counter(products)
    assert counts[(m, 1600, 320)] == 2 * 18  # k and v
    assert counts[(m, 1600, 3200)] == 2 * 32 and counts[(m, 3200, 100)] == 32
    assert counts[(m, 100, 3200)] == 32 and counts[(m, 3200, 16)] == 2 * 32
    assert (m, 1600, 32001) not in counts  # the tied head
    flops = work.batch_flops(c, k, s)
    assert flops > sum(2 * a * b * n for a, b, n in products) + 2 * k * s * 1600 * 32001


def test_each_layer_attends_within_its_own_window_with_the_meta_tokens():
    c = _published()
    fam = families.of(c)
    t = 128 + 2048
    glob = t * (t + 1) // 2
    i = np.arange(t)
    windowed = int((np.minimum(i + 1, 1024) + np.minimum(np.maximum(i - 1023, 0), 128)).sum())
    for layer, want in ((0, glob), (1, windowed), (15, glob), (30, windowed), (31, glob)):
        nbytes, flops = fam.flash_layer_work(c, layer, 1, 2048)
        assert flops == 4 * 64 * 25 * want, layer
        assert nbytes == 4 * (2 * 25 * t * 64 + 2 * 5 * t * 64)
    total = sum(max(fam.flash_layer_work(c, j, 1, 2048)[1] / 495e12,
                    fam.flash_layer_work(c, j, 1, 2048)[0] / 3.35e12) for j in range(32))
    assert work.flash_bound_s(c, 1, 2048) == pytest.approx(total, rel=1e-12)


def test_the_scans_bytes_by_hand():
    c = _published()
    fam = families.of(c)
    t = 4 * (128 + 1024)
    assert fam.scan_bytes(c, 4, 1024) == 4 * (4 * t * 3200 + 2 * t * 16)
    assert fam.scan_bound_s(c, 4, 1024) == 32 * fam.scan_bytes(c, 4, 1024) / 3.35e12
    assert fam.scan_flops(c, 4, 1024) == 32 * 6 * t * 3200 * 16


def _run(cfg, batches, kernels, launches):
    ends = np.array([int(v * 1e9) for v in kernels.values()], np.int64)
    tr = Trace(names=list(kernels), start_ns=np.zeros_like(ends), end_ns=ends,
               window=(0, int(ends.max())))
    return harness.Run(cell=types.SimpleNamespace(config=cfg), sim=None, counted=[], t_end_ms=0.0,
                       slo_ms=0.0, lm=None, setup_s=0.0, failed=set(),
                       batches=[{"k_pad": k, "bucket": s} for k, s in batches], trace=tr,
                       launches=launches)


def test_the_scan_roofline_by_hand_and_where_it_reads_nothing():
    c = TINY["hymba"]
    read = harness.load_metric("ssm_scan_roofline")
    kernels = {"void repro_torch::(anonymous namespace)::selective_scan_kernel<16>(float const*)": 2e-3,
               "gemm_kernel<32>": 1e-3}
    full = {(1, 32): {"selective_scan": 4}, (2, 64): {"selective_scan": 4}}
    got = read(_run(c, [(1, 32), (2, 64), (1, 32)], kernels, full))
    fam = families.of(c)
    want = 100.0 * (2 * fam.scan_bound_s(c, 1, 32) + fam.scan_bound_s(c, 2, 64)) / 2e-3
    assert got == pytest.approx(want, rel=1e-12)
    short = {(1, 32): {"selective_scan": 3}, (2, 64): {"selective_scan": 4}}
    assert read(_run(c, [(1, 32), (2, 64)], kernels, short)) is None
    assert read(_run(c, [(1, 32)], {"gemm_kernel<32>": 1e-3}, full)) is None
    assert read(_run(TINY["attn"], [(1, 32)], kernels, full)) is None  # a family without a scan


def test_the_drawn_mamba_leaves_sit_where_the_family_says():
    w = make_weights(TINY["hymba"], 2**31 + 1, "cpu")
    assert abs(float(w["dt_bias"].mean()) + 4.0) < 0.1
    assert torch.allclose(w["a_log"].mean((0, 1)), torch.log(torch.arange(1.0, 17.0)), atol=0.1)
    assert w["wk"].shape[0] == len(ref_hymba.producers(TINY["hymba"])) == 3


SEEDS = (2**31 + 111, 2**31 + 222, 2**31 + 333)


@pytest.mark.cuda
def test_tf32_control_fails_the_limits():
    """At full size on the card: the reference with TF32 products, in the
    program's place, fails ``checks/hymba_1_5b.json`` on every seed (the
    longest prompt of the stream's first seconds and five others)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    cell = harness.load_cell(CELL)
    limits = cell.checks["limits"]
    for seed in SEEDS:
        stream = traffic.make_stream(cell.traffic, cell.mix, seed, 4_000.0, (256, 512, 1024, 2048))
        prompts = [max(stream.prompts, key=len)] + stream.prompts[:5]
        w = make_weights(cell.config, seed, card)
        worst = {k: 0.0 for k in limits}
        for p in prompts:
            tokens = torch.from_numpy(np.asarray(p))
            r = harness.readings(reference.logits(cell.config, w, tokens),
                                 reference.logits(cell.config, w, tokens, tf32=True))
            worst = {k: max(worst[k], r[k]) for k in limits}
        del w
        torch.cuda.empty_cache()
        assert any(worst[k] > limits[k] for k in limits), (seed, worst, limits)
