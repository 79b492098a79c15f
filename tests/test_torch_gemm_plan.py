"""The float32 GEMM's host side (``repro_torch.kernels.gemm``), on the CPU:
its launch plan at every shape the models give it, the rule that routes a
product to it, and its split-TF32 arithmetic emulated tile by tile against
float64.  The kernel itself runs in ``tests/test_torch_cuda.py``."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import gemm, ops
from repro_torch.serving.engine import EngineConfig

from _tf32 import tf32

SMS = 132  # the H100 SXM's multiprocessors


def _products(cfg) -> dict[str, tuple[int, int]]:
    """A dense attention model's weight products, (K, N) by name."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out = {"q": (d, cfg.n_heads * hd), "kv": (d, cfg.n_kv_heads * hd), "o": (cfg.n_heads * hd, d),
           "up": (d, cfg.d_ff), "down": (cfg.d_ff, d)}
    if not cfg.tie_embeddings:
        out["head"] = (d, cfg.vocab_size)
    return out


GLM4 = get_config("glm4_9b")
ECFG = EngineConfig()
SERVING_ROWS = sorted({k * b for k, b in itertools.product(ECFG.batch_sizes, ECFG.buckets)})
DECODE_ROWS = [1, 8]
OTHER_F32 = ["orloj_gpt", "arctic_480b", "hymba_1_5b", "granite_34b", "dbrx_132b", "nemotron_4_340b"]


def _check_plan(plan: gemm.GemmPlan, m: int, n: int, k: int) -> None:
    assert plan == gemm.gemm_plan(m, n, k, SMS)  # a pure function of the shape
    assert plan.tokens in gemm.TOKENS and plan.warpgroups == gemm.WARPGROUPS and plan.block_k == 32
    # the token width holds the rows with less than a width's padding
    tiles_m = -(-m // plan.tokens)
    assert tiles_m * plan.tokens - m < plan.tokens
    if m <= 128:
        assert tiles_m == 1 and (plan.tokens == 8 or plan.tokens // 2 < m)
    else:
        assert plan.tokens in (64, 128)
    # the ring: RING_STAGES where they fit the block's shared memory, at least two
    assert 2 <= plan.stages == min(gemm.RING_STAGES, gemm.max_stages(plan.tokens)) <= gemm.MAX_STAGES
    assert plan.shared_bytes == gemm.shared_bytes(plan.tokens, plan.stages) <= gemm.MAX_SHARED
    # every split has a K tile, and the splits cover K
    k_tiles = -(-k // 32)
    assert plan.splits >= 1 and (plan.splits - 1) * plan.tiles_per_split < k_tiles
    assert plan.splits * plan.tiles_per_split >= k_tiles
    assert gemm.partial_floats(m, n, plan.splits) * 4 <= gemm.MAX_PARTIAL_BYTES
    # the plan is the cost model's fastest
    chosen = gemm.plan_seconds(m, n, k, plan.tokens, plan.splits, SMS)
    assert all(chosen <= gemm.plan_seconds(m, n, k, t, s, SMS) for s in range(1, 65)
               for t in ((plan.tokens,) if m <= 128 else (64, 128))
               if gemm.partial_floats(m, n, s) * 4 <= gemm.MAX_PARTIAL_BYTES)


@pytest.mark.parametrize("name", list(_products(GLM4)))
@pytest.mark.parametrize("m", SERVING_ROWS + DECODE_ROWS)
def test_glm4_plans_at_every_serving_shape_and_decode(m, name):
    k, n = _products(GLM4)[name]
    plan = gemm.gemm_plan(m, n, k, SMS)
    _check_plan(plan, m, n, k)
    blocks = plan.tiles(m, n) * plan.splits
    if name == "kv":  # two feature tiles at 256 rows or fewer: split along K
        assert plan.splits >= 4 and blocks >= 32
    if name in ("q", "o", "down") and m <= 256:
        assert plan.splits > 1 and blocks >= SMS // 2  # 32 feature tiles alone leave most of the card idle
    if name == "head":
        assert plan.splits == 1  # 1184 feature tiles fill the card many times


@pytest.mark.parametrize("arch", OTHER_F32)
@pytest.mark.parametrize("m", [1, 8, 32, 256, 2048])
def test_plans_at_the_other_configs_widths(arch, m):
    for k, n in _products(get_config(arch)).values():
        if k % 4 or n % 4:
            continue  # the plain product's (Hymba's vocabulary of 32001)
        _check_plan(gemm.gemm_plan(m, n, k, SMS), m, n, k)


def test_token_widths_and_splits():
    assert [gemm.token_width(m) for m in (1, 8, 9, 32, 37, 64, 65, 128, 129, 192, 193, 256)] == \
        [8, 8, 16, 32, 64, 64, 128, 128, 64, 64, 128, 128]
    assert gemm.token_width(384) == 128 and gemm.token_width(2048) == 128
    assert gemm.split_plan(4096, 3) == (3, 43) and gemm.split_plan(4096, 1) == (1, 128)
    assert gemm.split_plan(13696, 4) == (4, 107) and gemm.split_plan(64, 64) == (2, 1)
    assert gemm.weight_products(GLM4) == 281


# ----------------------------------------------------------- the routing
def _card(monkeypatch):
    """Let CPU tensors pass the device test, so that the other rules show."""
    monkeypatch.setattr(gemm, "_on_card", lambda *ts: True)


def test_routing_takes_float32_products_that_need_no_gradient(monkeypatch):
    x, w = torch.randn(3, 5, 64), torch.randn(64, 4, 8)
    assert not gemm.takes(x, w)  # the CPU
    _card(monkeypatch)
    assert gemm.takes(x, w) and gemm.takes(x, w.flatten(1)) and gemm.takes(x[0, :1], w)
    assert gemm.takes(torch.randn(2, 3, 512), torch.randn(8, 64, 32).flatten(0, 1))  # wo (H·hd, d)
    assert not gemm.takes(x.bfloat16(), w.bfloat16())  # bf16: cuBLAS's tensor cores already
    assert not gemm.takes(x, w.clone().requires_grad_(True))  # the training step's
    with torch.no_grad():
        assert gemm.takes(x, w.clone().requires_grad_(True))
    assert not gemm.takes(torch.randn(3, 50), torch.randn(50, 8))  # K off a multiple of 4
    assert not gemm.takes(torch.randn(3, 64), torch.randn(64, 50257))  # a vocabulary of 50257
    assert not gemm.takes(x, torch.randn(32, 64).T)  # a tied table, transposed: N not contiguous
    assert not gemm.takes(x, torch.randn(64, 9)[:, :8])  # rows 36 bytes apart
    assert not gemm.takes(torch.randn(0, 64), w)  # no rows


def test_matmul_takes_the_plain_product_on_the_cpu():
    x, w = torch.randn(3, 5, 64), torch.randn(64, 4, 8)
    before = gemm.launches
    out = ops.matmul(x, w)
    assert torch.equal(out, (x @ w.reshape(64, -1)).unflatten(-1, (4, 8)))
    assert torch.equal(ops.matmul(x, w.flatten(1)), x @ w.flatten(1))
    assert gemm.launches == before


# ------------------------------------------------ the kernel's arithmetic
def _kernel_emulated(x: torch.Tensor, w: torch.Tensor, plan: gemm.GemmPlan, passes: int) -> torch.Tensor:
    """The kernel's product, tile by tile: for each split, its run of
    32-deep K tiles in 8-deep k-steps, each k-step's passes (small·big,
    big·small, big·big; one pass: big·big) added to a float32 accumulator
    in that order; then the splits' partials added in split order."""
    k = x.shape[1]
    xb = tf32(x)
    xs = tf32(x - xb)
    wb = tf32(w)
    ws = tf32(w - wb)
    steps = -(-k // 8)
    per = plan.tiles_per_split * 4  # k-steps a split
    out = None
    for s in range(plan.splits):
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
        for j in range(s * per, min(steps, (s + 1) * per)):
            sl = slice(8 * j, 8 * j + 8)
            terms = ((wb, xb),) if passes == 1 else ((ws, xb), (wb, xs), (wb, xb))
            for a, b in terms:
                acc = acc + b[:, sl] @ a[sl]
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("k", [4096, 13696])
def test_split_tf32_arithmetic_stays_in_float32s_band(k):
    """Three passes stay within 4x the float32 product's error of float64;
    one pass lies 100x or more outside it.  The plan is GLM-4-9B's at 32
    rows (split along K), the product cut to 8 x 64 outputs."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((8, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, 64)) / np.sqrt(k)).astype(np.float32))
    plan = gemm.gemm_plan(32, 4096, k, SMS)
    assert plan.splits > 1
    want = x.double() @ w.double()
    scale = want.abs().max().item()

    def err(y):
        return (y.double() - want).abs().max().item() / scale

    f32 = torch.stack([(x[i:i + 1] @ w)[0] for i in range(8)])  # float32, one row at a time
    three = err(_kernel_emulated(x, w, plan, 3))
    one = err(_kernel_emulated(x, w, dataclasses.replace(plan, splits=1, tiles_per_split=k // 32), 1))
    assert three <= 4 * max(err(f32), 2.0**-24)
    assert one >= 100 * three


def test_the_operator_has_a_fake_implementation_and_a_flop_formula():
    """``repro_torch::gemm`` on meta tensors gives its output's shape and
    type without a card, and the FLOP counter counts 2·M·N·K for it."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.empty((37, 4096), device="meta")
    w = torch.empty((4096, 256), device="meta")
    with FlopCounterMode(display=False) as counter:
        y = torch.ops.repro_torch.gemm(x, w)
    assert y.device.type == "meta" and y.shape == (37, 256) and y.dtype == torch.float32
    assert counter.get_total_flops() == gemm.flops(37, 256, 4096) == 2 * 37 * 256 * 4096
