"""``work.py`` and the families' counts against counts made by hand at a tiny
configuration, against the program's own products, and GLM-4-9B's counts
against the values they had before the families were split out."""

from collections import Counter

import numpy as np
import pytest
import torch

from orloj_bench import families, harness, work
from orloj_bench.families import attn as attn_family
from orloj_bench.tests._tiny import TINY
from orloj_bench.trace import Trace


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
    assert attn_family.linear_flops_per_token(c) == 2 * per_layer + 2 * d * v
    k, s = 3, 8
    attn = 4 * 16 * (s * (s + 1) // 2) * 4 * k
    assert work.batch_flops(c, k, s) == k * s * (2 * per_layer + 2 * d * v) + 2 * attn


def test_flash_bound_is_the_larger_of_its_two():
    c = TINY["attn"]
    nbytes, flops = work.flash_layer_work(c, 8, 256)
    assert work.flash_layer_bound_s(c, 8, 256) == pytest.approx(
        max(flops / 495e12, nbytes / 3.35e12))
    assert work.flash_bound_s(c, 8, 256) == c["n_layers"] * work.flash_layer_bound_s(c, 8, 256)


def test_published_sizes_count_as_expected():
    from orloj_bench import traffic

    c = traffic.load("configs", "glm4_9b")
    # GLM-4-9B: ~9.4 B parameters, two FLOPs each a token.
    assert attn_family.linear_flops_per_token(c) == pytest.approx(17.6e9, rel=0.03)


# GLM-4-9B at every served (k, bucket) of the engine's defaults, as the
# counts read before the families were split out: ``batch_flops``, and one
# layer's flash bound, which the roofline multiplied by the 40 layers.
GLM4_9B_BATCH_FLOPS = {
    (1, 32): 562181439488, (1, 64): 1125033967616, (1, 128): 2252752289792,
    (1, 256): 4516241997824, (2, 32): 1124362878976, (2, 64): 2250067935232,
    (2, 128): 4505504579584, (2, 256): 9032483995648, (4, 32): 2248725757952,
    (4, 64): 4500135870464, (4, 128): 9011009159168, (4, 256): 18064967991296,
    (8, 32): 4497451515904, (8, 64): 9000271740928, (8, 128): 18022018318336,
    (8, 256): 36129935982592,
}
GLM4_9B_FLASH_LAYER_S = {
    (1, 32): 3.325707462686567e-07, (1, 64): 6.651414925373134e-07,
    (1, 128): 1.3302829850746268e-06, (1, 256): 2.6605659701492536e-06,
    (2, 32): 6.651414925373134e-07, (2, 64): 1.3302829850746268e-06,
    (2, 128): 2.6605659701492536e-06, (2, 256): 5.321131940298507e-06,
    (4, 32): 1.3302829850746268e-06, (4, 64): 2.6605659701492536e-06,
    (4, 128): 5.321131940298507e-06, (4, 256): 1.0642263880597014e-05,
    (8, 32): 2.6605659701492536e-06, (8, 64): 5.321131940298507e-06,
    (8, 128): 1.0642263880597014e-05, (8, 256): 2.128452776119403e-05,
}


@pytest.mark.parametrize("shape", sorted(GLM4_9B_BATCH_FLOPS), ids=lambda t: f"{t[0]}x{t[1]}")
def test_glm4_9b_counts_did_not_move(shape):
    from orloj_bench import traffic

    c = traffic.load("configs", "glm4_9b")
    k, s = shape
    engine = harness.engine_config(c)
    assert k in engine.batch_sizes and s in engine.buckets
    assert work.batch_flops(c, k, s) == GLM4_9B_BATCH_FLOPS[shape]
    assert work.flash_bound_s(c, k, s) == c["n_layers"] * GLM4_9B_FLASH_LAYER_S[shape]


def test_glm4_9b_products_are_the_forwards_281():
    from orloj_bench import traffic
    from repro_torch.kernels import gemm

    c = traffic.load("configs", "glm4_9b")
    products = families.of(c).gemm_products(c, 2, 64)
    assert len(products) == gemm.weight_products(harness.model_config(c)) == 281
    assert {m for m, _, _ in products} == {128}
    assert products[-1] == (128, 4096, 151552)


def _program_products(cfg: dict, k: int, s: int, monkeypatch) -> list[tuple[int, int, int]]:
    """(M, K, N) of every weight product the program's forward makes at a
    padded (k, s) batch, from its ``ops.matmul`` calls on the CPU."""
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from orloj_bench.weights import make_weights, port_params

    seen, real = [], ops.matmul

    def record(x, w):
        seen.append((x.numel() // x.shape[-1], w.shape[0], w[0].numel()))
        return real(x, w)

    monkeypatch.setattr(ops, "matmul", record)
    model = Model(harness.model_config(cfg), device="cpu")
    tokens = torch.ones((k, s), dtype=torch.int64)
    with torch.no_grad():
        model.logits(port_params(cfg, make_weights(cfg, 1, "cpu")), {"tokens": tokens})
    return seen


@pytest.mark.parametrize("kind", sorted(TINY))
def test_gemm_products_are_the_programs(kind, monkeypatch):
    cfg = TINY[kind]
    for k, s in ((1, 8), (3, 16)):
        want = families.of(cfg).gemm_products(cfg, k, s)
        assert Counter(_program_products(cfg, k, s, monkeypatch)) == Counter(want)
        assert work.batch_flops(cfg, k, s) >= sum(2 * m * kk * n for m, kk, n in want)


def _trace(kernels: dict[str, float]) -> Trace:
    ends = np.array([int(v * 1e9) for v in kernels.values()], np.int64)
    return Trace(names=list(kernels), start_ns=np.zeros_like(ends), end_ns=ends,
                 window=(0, int(ends.max())))


def _roofline(cfg: dict, batches: list[tuple[int, int]], kernels: dict[str, float],
              launches: dict | None = None):
    """gemm_roofline of a run that served ``batches`` with these kernels'
    device seconds; each served shape's graph counts one GEMM launch a
    listed product unless ``launches`` says otherwise."""
    import types

    if launches is None:
        launches = {(k, s): {"gemm": len(work.gemm_products(cfg, k, s)), "flash": 2}
                    for k, s in batches}
    run = harness.Run(cell=types.SimpleNamespace(config=cfg), sim=None, counted=[],
                      t_end_ms=0.0, slo_ms=0.0, lm=None, setup_s=0.0, failed=set(),
                      batches=[{"k_pad": k, "bucket": s} for k, s in batches],
                      trace=None if kernels is None else _trace(kernels), launches=launches)
    return harness.load_metric("gemm_roofline")(run)


KERNELS = {"void repro_torch::gemm_kernel<128>(CUtensorMap)": 2e-3,
           "repro_torch::GEMM_reduce_kernel(float4 const*)": 1e-3,
           "void repro_torch::flash_attention_kernel<float>": 5e-3,
           "rmsnorm_kernel": 1e-3}


def test_gemm_roofline_by_hand():
    c = TINY["attn"]  # d 64, q 4 x 16, kv 2 x 16, ff 96, vocab 300, 2 layers

    def nbytes(m):  # every product bytes-bound at these sizes: weight, input, output
        q = o = 4 * (64 * 64 + m * 64 + m * 64)
        k = v = 4 * (64 * 32 + m * 64 + m * 32)
        gate = up = 4 * (64 * 96 + m * 64 + m * 96)
        down = 4 * (96 * 64 + m * 96 + m * 64)
        head = 4 * (64 * 300 + m * 64 + m * 300)
        return 2 * (q + k + v + o + gate + up + down) + head

    got = _roofline(c, [(1, 32), (2, 64), (1, 32)], KERNELS)
    want = 100.0 * (2 * nbytes(32) + nbytes(128)) / 3.35e12 / 3e-3
    assert got == pytest.approx(want, rel=1e-12)


def test_a_products_bound_follows_the_configurations_dtype():
    f32 = TINY["attn"]
    bf16 = f32 | {"dtype": "bfloat16"}
    # Bytes-bound: both inputs and the output, 4 or 2 bytes an element.
    assert work.gemm_product_bound_s(f32, 32, 64, 96) == 4 * (64 * 96 + 32 * 64 + 32 * 96) / 3.35e12
    assert work.gemm_product_bound_s(bf16, 32, 64, 96) == 2 * (64 * 96 + 32 * 64 + 32 * 96) / 3.35e12
    # FLOP-bound: at the TF32 rate for float32, bfloat16's for bfloat16.
    assert work.gemm_product_bound_s(f32, 4096, 4096, 4096) == 2 * 4096**3 / 495e12
    assert work.gemm_product_bound_s(bf16, 4096, 4096, 4096) == 2 * 4096**3 / 989e12
    assert work.flash_layer_bound_s(bf16, 8, 256) == pytest.approx(
        work.flash_layer_bound_s(f32, 8, 256) / 2, rel=1e-12)
    with pytest.raises(ValueError, match="nosuch"):
        work.gemm_bound_s(f32 | {"dtype": "nosuch"}, 1, 32)


@pytest.mark.parametrize("kernels", [None, {"void repro_torch::flash_attention_kernel": 1e-3}])
def test_gemm_roofline_reads_nothing_without_a_gemm_kernel(kernels):
    assert _roofline(TINY["attn"], [(1, 32)], kernels) is None


@pytest.mark.parametrize("launches", [{}, {(1, 32): {"gemm": 15}, (2, 64): {}},
                                      {(1, 32): {"gemm": 15}, (2, 64): {"gemm": 16}}],
                         ids=["no_counts", "a_graph_without_gemm", "one_launch_more"])
def test_gemm_roofline_reads_nothing_where_the_launches_differ_from_the_products(launches):
    c = TINY["attn"]
    assert len(work.gemm_products(c, 1, 32)) == 15
    assert _roofline(c, [(1, 32), (2, 64)], KERNELS) is not None
    assert _roofline(c, [(1, 32), (2, 64)], KERNELS, launches) is None
