"""The port's kernels (attention, RMSNorm, MoE gating) against the JAX reference.

On a host without a card, the port's wrappers take their plain PyTorch
versions (the tensors lie on the CPU); these are held against
``repro.kernels.ref`` and against the Pallas kernels run by the Pallas
interpreter, on the shapes of ``tests/test_kernels.py`` and with its
tolerances (float32 2e-5: the two frameworks sum in another order;
bfloat16 2e-2: one bf16 rounding of the probabilities or the output).
The gating's expert ids must be equal, ties included.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _tf32 import tf32 as _tf32  # noqa: E402
from _tf32 import tf32_matmul as _tf32_matmul  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gating import moe_gating_pallas  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import moe_gating as gating_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(a: np.ndarray, dtype_name: str = "float32"):
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize(
    "b,h,kv,s,hd",
    [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 128, 128), (2, 2, 2, 64, 32),
     (4, 4, 4, 24, 16), (2, 8, 2, 64, 192)],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_ref(b, h, kv, s, hd, dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    out = ops.flash_attention(tq, tk, tv)
    assert out.dtype == tq.dtype and out.shape == (b, h, s, hd)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention_ref(jq, jk, jv)), **_tol(dtype))


@pytest.mark.parametrize("b,h,kv,s,hd", [(2, 8, 2, 256, 64), (2, 2, 2, 64, 32), (4, 4, 4, 32, 16),
                                        (2, 4, 2, 128, 192)])
def test_flash_plain_matches_pallas_interpreter(b, h, kv, s, hd):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)))
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)))
    want = jops.flash_attention(jq, jk, jv, use_pallas=True, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(ops.flash_attention(tq, tk, tv)), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_plain_lengths_mask_matches_pallas_and_alone():
    """The padded-batch model: a short request padded to the batch's length
    gives what it gives alone, and what the Pallas kernel gives."""
    rng = np.random.default_rng(1)
    b, h, s, hd = 3, 4, 128, 64
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)))
    jk, tk = _pair(rng.normal(size=(b, h, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, h, s, hd)))
    lens = [128, 70, 17]
    out = ops.flash_attention(tq, tk, tv, torch.tensor(lens, dtype=torch.int32))
    want = jops.flash_attention(
        jq, jk, jv, jnp.array(lens, jnp.int32), use_pallas=True, block_q=64, block_k=64
    )
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)
    for i, L in enumerate(lens):
        alone = ops.flash_attention(tq[i : i + 1, :, :L], tk[i : i + 1, :, :L], tv[i : i + 1, :, :L])
        np.testing.assert_allclose(_np(out[i, :, :L]), _np(alone[0]), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [16, 64])
def test_flash_plain_sliding_window(window):
    rng = np.random.default_rng(2)
    b, h, s, hd = 1, 2, 128, 32
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)))
    jk, tk = _pair(rng.normal(size=(b, h, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, h, s, hd)))
    out = ops.flash_attention(tq, tk, tv, window=window)
    np.testing.assert_allclose(
        _np(out), _np(jref.flash_attention_ref(jq, jk, jv, window=window)), rtol=2e-5, atol=2e-5
    )
    want = jops.flash_attention(jq, jk, jv, window=window, use_pallas=True, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_plain_noncausal():
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.normal(size=(1, 2, 64, 32)))
    jk, tk = _pair(rng.normal(size=(1, 2, 64, 32)))
    jv, tv = _pair(rng.normal(size=(1, 2, 64, 32)))
    out = ops.flash_attention(tq, tk, tv, causal=False)
    want = jops.flash_attention(jq, jk, jv, causal=False, use_pallas=True, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_plain_fully_masked_rows_are_zero():
    """lengths == 0 without causality masks every key: zeros, not NaN."""
    rng = np.random.default_rng(11)
    jq, tq = _pair(rng.normal(size=(2, 2, 48, 32)))
    jk, tk = _pair(rng.normal(size=(2, 2, 48, 32)))
    jv, tv = _pair(rng.normal(size=(2, 2, 48, 32)))
    lens = [0, 20]
    out = ops.flash_attention(tq, tk, tv, torch.tensor(lens, dtype=torch.int32), causal=False)
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all()
    want = jref.flash_attention_ref(jq, jk, jv, causal=False, lengths=jnp.array(lens, jnp.int32))
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


# ------------------------------------ the flash kernel's split-TF32 products
# The CUDA flash kernel computes float32 products on the tensor cores in
# TF32 (10 mantissa bits), three passes a product (``_tf32``).  These tests
# emulate that arithmetic on the CPU and record why three passes are
# needed: one misses the float32 tolerance of 2e-5.
def _tf32_flash(q, k, v, passes: int) -> torch.Tensor:
    """Causal GQA attention with the kernel's arithmetic: TF32 products,
    the scale after Q·Kᵀ, unnormalised probabilities into P·V, one division
    at the end."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    scores = _tf32_matmul(q, k.transpose(-1, -2), passes) / math.sqrt(hd)
    mask = torch.ones((s, s), dtype=torch.bool).tril()
    scores = torch.where(mask, scores, -1e30)
    p = torch.where(mask, torch.exp(scores - scores.amax(-1, keepdim=True)), 0.0)
    return _tf32_matmul(p, v, passes) / p.sum(-1, keepdim=True)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2**-12, one + 2**-11, one + 3 * 2**-11, -(one + 2**-11), 2**-10 + 2**-21, 0.0])
    want = torch.tensor([one, one + 2**-10, one + 2**-9, -(one + 2**-10), 2**-10 + 2**-20, 0.0])
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    assert (_tf32(y) - y).abs().max() <= y.abs().max() * 2**-11
    assert torch.all(_tf32(y).view(torch.int32) & 0x1FFF == 0)


@pytest.mark.parametrize("b,h,kv,s,hd", [(2, 4, 4, 256, 64), (1, 7, 1, 256, 128)])
def test_split_tf32_attention_matches_jax_ref(b, h, kv, s, hd):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)))
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)))
    want = _np(jref.flash_attention_ref(jq, jk, jv))
    np.testing.assert_allclose(_np(_tf32_flash(tq, tk, tv, passes=3)), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,h,kv,s,hd", [(2, 4, 4, 256, 64), (1, 7, 1, 256, 128)])
def test_one_tf32_pass_misses_the_float32_tolerance(b, h, kv, s, hd):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)))
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)))
    want = _np(jref.flash_attention_ref(jq, jk, jv))
    err = np.abs(_np(_tf32_flash(tq, tk, tv, passes=1)) - want).max()
    assert err > 2e-5


# ------------------------------------------------------- decode attention
@pytest.mark.parametrize("b,h,kv,s,hd", [(2, 8, 2, 512, 64), (1, 4, 4, 256, 128), (4, 8, 1, 1024, 64),
                                        (4, 4, 4, 32, 16), (2, 24, 2, 256, 192),
                                        (2, 32, 2, 256, 128),  # GLM-4-9B's group of 16
                                        (2, 48, 1, 256, 128),  # Granite-34B's MQA group of 48
                                        (2, 4, 4, 256, 512)])  # xLSTM-1.3B's head size 512
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_ref(b, h, kv, s, hd, dtype):
    """The plain version (chip_smoke's yardstick for the kernel) against the
    JAX reference and the Pallas kernel in the Pallas interpreter."""
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng.normal(size=(b, h, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    valid = rng.integers(1, s + 1, size=(b,)).astype(np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid))
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), use_pallas=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("s,block_k", [(300, 256), (96, 64), (7, 256), (130, 128)])
def test_decode_plain_matches_pallas_any_cache_length(s, block_k):
    rng = np.random.default_rng(9)
    b, h, kv, hd = 2, 4, 2, 64
    jq, tq = _pair(rng.normal(size=(b, h, hd)))
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)))
    valid = rng.integers(1, s + 1, size=(b,)).astype(np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), use_pallas=True, block_k=block_k)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,block_k,hd", [(32, 32, 16), (100, 64, 16), (130, 128, 192), (7, 256, 192)])
def test_decode_plain_matches_pallas_head_dims_16_and_192(s, block_k, hd):
    """The engine-smoke toy's head size and Nemotron-4-340B's."""
    rng = np.random.default_rng(12)
    b, h, kv = 2, 6, 2
    jq, tq = _pair(rng.normal(size=(b, h, hd)))
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)))
    valid = np.array([s, max(1, s // 3)], np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), use_pallas=True, block_k=block_k)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


def test_decode_plain_empty_rows():
    rng = np.random.default_rng(10)
    b, h, kv, s, hd = 3, 4, 2, 128, 64
    jq, tq = _pair(rng.normal(size=(b, h, hd)))
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)))
    valid = np.array([0, 77, 0], np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all() and (out[2] == 0).all()
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), use_pallas=True, block_k=64)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


def test_decode_plain_matches_flash_last_row():
    rng = np.random.default_rng(5)
    b, h, s, hd = 1, 4, 128, 64
    _, tq = _pair(rng.normal(size=(b, h, s, hd)))
    _, tk = _pair(rng.normal(size=(b, h, s, hd)))
    _, tv = _pair(rng.normal(size=(b, h, s, hd)))
    full = ops.flash_attention(tq, tk, tv)
    dec = ops.decode_attention(tq[:, :, -1].contiguous(), tk, tv, torch.tensor([s], dtype=torch.int32))
    np.testing.assert_allclose(_np(full[:, :, -1]), _np(dec), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("t,d", [(256, 128), (512, 1024), (64, 896), (7, 1024), (300, 7168)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax_ref(t, d, dtype):
    """The shapes of ``test_kernels.py``, a ragged T and Arctic's width."""
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.normal(size=(t, d)) * 3, dtype)
    scale = rng.normal(size=(d,)).astype(np.float32)
    out = ops.rmsnorm(tx, torch.from_numpy(scale))
    assert out.dtype == tx.dtype and out.shape == (t, d)
    want = jref.rmsnorm_ref(jx, jnp.asarray(scale))
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))


@pytest.mark.parametrize("t,d", [(256, 128), (512, 1024), (64, 896)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_interpreter(t, d, dtype):
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.normal(size=(t, d)) * 3, dtype)
    scale = rng.normal(size=(d,)).astype(np.float32)
    want = jops.rmsnorm(jx, jnp.asarray(scale), use_pallas=True)
    np.testing.assert_allclose(_np(ops.rmsnorm(tx, torch.from_numpy(scale))), _np(want), **_tol(dtype))


def test_rmsnorm_plain_nd_input_and_eps():
    """(..., d) is flattened to rows; eps is passed through (the models use
    1e-5, the wrapper's default is the reference wrapper's 1e-6)."""
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng.normal(size=(2, 128, 64)) * 1e-3)
    scale = rng.normal(size=(64,)).astype(np.float32)
    for eps in (1e-6, 1e-5):
        out = ops.rmsnorm(tx, torch.from_numpy(scale), eps=eps)
        assert out.shape == (2, 128, 64)
        want = jops.rmsnorm(jx, jnp.asarray(scale), eps=eps, use_pallas=True)
        np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)
    loose = ops.rmsnorm(tx, torch.from_numpy(scale), eps=1e-5)
    assert not torch.allclose(ops.rmsnorm(tx, torch.from_numpy(scale)), loose, rtol=1e-3, atol=0)


# ------------------------------------------------------------ moe gating
def _gating_pair(logits: np.ndarray, k: int):
    got = ops.moe_gating(torch.from_numpy(logits), k)
    want = moe_gating_pallas(jnp.asarray(logits), k, interpret=True)
    return got, want


@pytest.mark.parametrize("t,e,k", [(256, 16, 4), (512, 128, 2), (256, 8, 1)])
def test_moe_gating_plain_matches_pallas_interpreter(t, e, k):
    """Ids array-equal; gates within 1e-5 and normalised over the k."""
    logits = np.random.default_rng(8).normal(size=(t, e)).astype(np.float32) * 2
    (gates, ids), (wg, wi) = _gating_pair(logits, k)
    assert gates.dtype == torch.float32 and ids.dtype == torch.int32 and ids.shape == (t, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gates.numpy(), np.asarray(wg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    rg, ri = jref.moe_gating_ref(jnp.asarray(logits), k)  # lax.top_k: the same ids
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rg), rtol=1e-5, atol=1e-5)


def test_moe_gating_plain_ties_go_to_the_lowest_index():
    """Rows of equal logits and rows with duplicated maxima."""
    e = 16
    logits = np.zeros((8, e), np.float32)
    logits[1] = 3.0
    logits[2, [3, 9, 12]] = 5.0
    logits[3, [15, 0]] = 2.0
    logits[4, [7, 8]] = 1.0
    logits[4, 2] = 4.0
    logits[5] = np.arange(e) % 4  # every maximum four times
    logits[6, ::2] = -1.0
    logits[7] = np.random.default_rng(13).normal(size=e)
    for k in (1, 2, 4):
        (gates, ids), (wg, wi) = _gating_pair(logits, k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gates.numpy(), np.asarray(wg), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ids[:3].numpy(), [[0, 1, 2, 3], [0, 1, 2, 3], [3, 9, 12, 0]])
    np.testing.assert_array_equal(ids[5].numpy(), [3, 7, 11, 15])


# ------------------------------------ the gating kernel's selection rule
# The CUDA gating kernel gives each row to a warp.  A pass takes each lane's
# best slot (a strict >, over slots in increasing expert order), then two
# `redux.sync`: the maximum over the lanes of an int32 key that orders
# floats as their values do, and the minimum of the expert index over the
# lanes whose key equals it.  These tests emulate that arithmetic on the
# CPU, lane by lane, in both layouts the kernel takes (lane l holding
# experts l, l + 32, ... or 4l .. 4l+3 of each 128), and hold its ids to
# the plain version and to the Pallas interpreter.
def _order_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's key: a float's bits, with a negative float's magnitude
    bits flipped (an arithmetic shift spreads the sign bit)."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _key_value(key: torch.Tensor) -> torch.Tensor:
    return (key ^ ((key >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _lane_layout(e: int, vec: int) -> torch.Tensor:
    """(32, slots) expert index of each lane's slots, as the kernel lays
    them out (VEC adjacent experts a load, chunks of 32·VEC); slots past E
    hold an index >= E."""
    chunks = -(-e // (32 * vec))
    j = torch.arange(vec * chunks)
    lane = torch.arange(32)[:, None]
    return 32 * vec * (j // vec) + vec * lane + j % vec


def _redux_gating(logits: torch.Tensor, k: int, vec: int):
    """The kernel's logit maximum and selection, with the plain version's
    exp, sum and division in between."""
    x = logits.float()
    expert = _lane_layout(x.shape[1], vec)  # (32, slots)
    valid = expert < x.shape[1]
    slots = torch.where(valid, x[:, expert.clamp_max(x.shape[1] - 1)], -math.inf)  # (T, 32, slots)
    mx = _key_value(_order_key(slots.amax(-1)).max(-1).values)  # one __reduce_max_sync
    p = torch.exp(x - mx[:, None])
    p = p / p.sum(-1, keepdim=True)
    slots = torch.where(valid, p[:, expert.clamp_max(x.shape[1] - 1)], -math.inf)
    gsum = torch.zeros(x.shape[0])
    gates, ids = [], []
    for _ in range(k):
        j = torch.argmax(slots, dim=-1, keepdim=True)  # the first maximum: a strict >
        best = slots.gather(-1, j)[..., 0]  # (T, 32)
        bi = expert.expand(x.shape[0], -1, -1).gather(-1, j)[..., 0]
        key = _order_key(best)
        top = key.max(-1).values  # __reduce_max_sync
        idx = torch.where(key == top[:, None], bi, 2**31 - 1).min(-1).values  # __reduce_min_sync
        val = _key_value(top)
        gates.append(val)
        ids.append(idx.to(torch.int32))
        gsum = gsum + val
        slots = torch.where(expert == idx[:, None, None], -1.0, slots)
    return torch.stack(gates, -1) / torch.clamp_min(gsum, 1e-9)[:, None], torch.stack(ids, -1)


def test_order_key_preserves_float_order():
    tiny = torch.tensor(2.0**-149)  # the smallest subnormal
    x = torch.tensor([-math.inf, -1.0, 0.0, tiny.item(), 1.0])
    assert tiny.item() > 0 and torch.equal(x[3:4], tiny[None])
    key = _order_key(x)
    assert (key[1:] > key[:-1]).all()
    assert torch.equal(_key_value(key).view(torch.int32), x.view(torch.int32))
    y = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32) * 10.0)
    y = torch.cat([y, x, torch.tensor([-0.0, math.inf])])
    ky = _order_key(y)
    assert torch.equal(torch.sort(ky).values, _order_key(torch.sort(y).values))
    assert torch.equal(_key_value(ky).view(torch.int32), y.view(torch.int32))


def _neg_inf_logits() -> np.ndarray:
    x = np.random.default_rng(21).normal(size=(4, 16)).astype(np.float32)
    x[0, 1:] = -np.inf  # one finite logit: fifteen zero probabilities, tied
    x[1, ::2] = -np.inf
    x[2, :14] = -np.inf
    x[3, [3, 7]] = -np.inf
    return x


def _gating_case(name: str) -> tuple[np.ndarray, int]:
    from test_torch_cuda import _tie_logits

    rng = np.random.default_rng(22)
    return {
        "ties": (_tie_logits("cpu").numpy(), 4),
        "-inf logits": (_neg_inf_logits(), 4),
        "k == E": (rng.normal(size=(16, 8)).astype(np.float32) * 2, 8),
        "k == E, E 3": (rng.normal(size=(16, 3)).astype(np.float32) * 2, 3),
        "random (64,128)": (rng.normal(size=(64, 128)).astype(np.float32) * 2, 2),
        "random (64,130)": (rng.normal(size=(64, 130)).astype(np.float32) * 2, 4),
        "random (64,256)": (rng.normal(size=(64, 256)).astype(np.float32) * 2, 2),
    }[name]


@pytest.mark.parametrize("vec", [1, 4])
@pytest.mark.parametrize(
    "case", ["ties", "-inf logits", "k == E", "k == E, E 3", "random (64,128)", "random (64,130)", "random (64,256)"]
)
def test_redux_selection_matches_plain_and_pallas(case, vec):
    logits, k = _gating_case(case)
    if vec == 4 and logits.shape[1] % 4:
        vec = 1  # as the kernel's launcher: the float4 layout needs E % 4 == 0
    gates, ids = _redux_gating(torch.from_numpy(logits), k, vec)
    want_g, want_i = ref.moe_gating_ref(torch.from_numpy(logits), k)
    assert torch.equal(ids, want_i)
    assert torch.equal(gates, want_g)  # the same probabilities, summed in the same pass order
    _, pallas_i = moe_gating_pallas(jnp.asarray(logits), k, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(pallas_i))


# ---------------------------------------------------------- the wrappers
def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.normal(size=(1, 2, 16, 32)).astype(np.float32))
    qd = torch.from_numpy(rng.normal(size=(1, 2, 32)).astype(np.float32))
    ops.reset_launch_counts()
    a = ops.flash_attention(q, q, q, window=4)
    d = ops.decode_attention(qd, q, q, torch.tensor([9], dtype=torch.int32))
    torch.testing.assert_close(a, ref.flash_attention_ref(q, q, q, window=4), rtol=0, atol=0)
    torch.testing.assert_close(
        d, ref.decode_attention_ref(qd, q, q, torch.tensor([9], dtype=torch.int32)), rtol=0, atol=0
    )
    assert ops.launch_counts() == {
        "flash_attention": 0, "decode_attention": 0, "rmsnorm": 0, "moe_gating": 0,
        "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "moe_gating_bwd": 0, "gemm": 0,
        "selective_scan": 0,
    }


def test_cpu_tensors_launch_neither_new_kernel():
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(2, 5, 40)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))
    logits = torch.from_numpy(rng.normal(size=(10, 8)).astype(np.float32))
    ops.reset_launch_counts()
    y = ops.rmsnorm(x, scale, eps=1e-5)
    gates, ids = ops.moe_gating(logits, 2)
    torch.testing.assert_close(y, ref.rmsnorm_ref(x.reshape(10, 40), scale, 1e-5).reshape(x.shape),
                               rtol=0, atol=0)
    wg, wi = ref.moe_gating_ref(logits, 2)
    assert torch.equal(ids, wi) and torch.equal(gates, wg)
    assert ops.launch_counts() == {
        "flash_attention": 0, "decode_attention": 0, "rmsnorm": 0, "moe_gating": 0,
        "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "moe_gating_bwd": 0, "gemm": 0,
        "selective_scan": 0,
    }


def test_other_devices_raise():
    """A meta tensor (no data: the dry-run's shards) takes the kernel's
    operator, whose fake implementation gives the outputs' shapes and
    types and launches nothing; a device the port has no kernel for
    raises."""
    q = torch.empty((1, 2, 16, 32), device="meta")
    before = ops.launch_counts()
    out = ops.flash_attention(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    dec = ops.decode_attention(q[:, :, 0], q, q, torch.empty((1,), dtype=torch.int32, device="meta"))
    assert dec.device.type == "meta" and dec.shape == (1, 2, 32)
    assert ops.launch_counts() == before
    for dev in ("xpu", "mps"):
        with pytest.raises(ValueError, match="no kernel"):
            ops._route(types.SimpleNamespace(device=torch.device(dev)))


@pytest.mark.parametrize(
    "case,err",
    [
        ("hd48", ValueError),
        ("float16", TypeError),
        ("kv_shape", ValueError),
        ("heads", ValueError),
        ("lengths_dtype", ValueError),
        ("inner_stride", ValueError),
        ("unaligned_rows", ValueError),
        ("unaligned_start", ValueError),
    ],
)
def test_flash_checks_reject_what_the_kernel_does_not_take(case, err):
    q = torch.zeros((2, 4, 16, 64))
    k = torch.zeros((2, 2, 16, 64))
    lengths = None
    if case == "hd48":
        q, k = torch.zeros((2, 4, 16, 48)), torch.zeros((2, 2, 16, 48))
    elif case == "float16":
        q, k = q.half(), k.half()
    elif case == "kv_shape":
        k = torch.zeros((2, 2, 15, 64))
    elif case == "heads":
        k = torch.zeros((2, 3, 16, 64))
    elif case == "lengths_dtype":
        lengths = torch.zeros((2,), dtype=torch.int64)
    elif case == "inner_stride":
        q = torch.zeros((2, 4, 64, 16)).transpose(2, 3)
    elif case == "unaligned_rows":  # rows 66 floats apart: not a multiple of 16 bytes
        q = torch.zeros((2, 4, 16, 66))[..., :64]
    elif case == "unaligned_start":  # contiguous, but 4 bytes past a 16-byte boundary
        k = torch.zeros(2 * 2 * 16 * 64 + 1)[1:].view(2, 2, 16, 64)
    with pytest.raises(err):
        fa_mod.check_inputs(q, k, k, lengths)


def test_flash_checks_accept_strided_views():
    """The model passes (B, S, H, hd) projections as (B, H, S, hd) views."""
    x = torch.zeros((2, 16, 4, 64)).transpose(1, 2)
    fa_mod.check_inputs(x, x, x, torch.zeros((2,), dtype=torch.int32))


@pytest.mark.parametrize(
    "case", ["dtype", "noncontig", "valid_dtype", "cache_shape", "hd48", "unaligned"]
)
def test_decode_checks_reject_what_the_kernel_does_not_take(case):
    q = torch.zeros((2, 4, 64))
    kc = torch.zeros((2, 2, 32, 64))
    valid = torch.zeros((2,), dtype=torch.int32)
    if case == "dtype":
        q = q.double()
    elif case == "noncontig":
        kc = torch.zeros((2, 2, 64, 32)).transpose(2, 3)
    elif case == "valid_dtype":
        valid = valid.long()
    elif case == "cache_shape":
        kc = torch.zeros((2, 2, 32, 32))
    elif case == "hd48":
        q, kc = torch.zeros((2, 4, 48)), torch.zeros((2, 2, 32, 48))
    elif case == "unaligned":  # contiguous, but 4 bytes past a 16-byte boundary
        kc = torch.zeros(2 * 2 * 32 * 64 + 1)[1:].view(2, 2, 32, 64)
    with pytest.raises((ValueError, TypeError)):
        dec_mod.check_inputs(q, kc, kc, valid)


@pytest.mark.parametrize("case", ["1d", "scale_shape", "float16", "scale_bf16", "noncontig", "empty"])
def test_rmsnorm_checks_reject_what_the_kernel_does_not_take(case):
    x, scale = torch.zeros((4, 64)), torch.ones(64)
    if case == "1d":
        x = torch.zeros(64)
    elif case == "scale_shape":
        scale = torch.ones(32)
    elif case == "float16":
        x = x.half()
    elif case == "scale_bf16":
        scale = scale.bfloat16()
    elif case == "noncontig":
        x = torch.zeros((64, 4)).T
    elif case == "empty":
        x = torch.zeros((0, 64))
    with pytest.raises((ValueError, TypeError)):
        rms_mod.check_inputs(x, scale)


@pytest.mark.parametrize("case,k", [("ok", 2), ("k0", 0), ("k_over_e", 9), ("experts", 2),
                                    ("float64", 2), ("noncontig", 2), ("3d", 2)])
def test_moe_gating_checks_reject_what_the_kernel_does_not_take(case, k):
    logits = torch.zeros((16, 8))
    if case == "experts":
        logits = torch.zeros((16, 257))
    elif case == "float64":
        logits = logits.double()
    elif case == "noncontig":
        logits = torch.zeros((8, 16)).T
    elif case == "3d":
        logits = torch.zeros((2, 8, 8))
    if case == "ok":
        gating_mod.check_inputs(logits, k)
        return
    with pytest.raises((ValueError, TypeError)):
        gating_mod.check_inputs(logits, k)


@pytest.mark.parametrize("case", ["flash lse shape", "flash out shape", "flash on the cpu",
                                  "flash hd 512", "rmsnorm dy shape", "rmsnorm d too wide",
                                  "rmsnorm on the cpu", "gating ids int64", "gating dgates shape",
                                  "gating on the cpu"])
def test_backward_launchers_reject_what_their_kernels_do_not_take(case):
    """The backward launchers check shapes, types and the device before any
    build or launch, so these raise here, without a card or nvcc."""
    q = torch.zeros((2, 4, 16, 64))
    k = torch.zeros((2, 2, 16, 64))
    lse = torch.zeros((2, 4, 16))
    x, scale = torch.zeros((8, 64)), torch.ones(64)
    logits, ids, dg = torch.zeros((8, 16)), torch.zeros((8, 2), dtype=torch.int32), torch.zeros((8, 2))
    with pytest.raises((ValueError, TypeError)):
        if case == "flash lse shape":
            fa_mod.flash_attention_backward_cuda(q, k, k, q, q, lse[:, :, :8])
        elif case == "flash out shape":
            fa_mod.flash_attention_backward_cuda(q, k, k, q[:, :2], q, lse)
        elif case == "flash on the cpu":
            fa_mod.flash_attention_backward_cuda(q, k, k, q, q, lse)
        elif case == "flash hd 512":
            big = torch.zeros((1, 1, 4, 512))
            fa_mod.flash_attention_backward_cuda(big, big, big, big, big, torch.zeros((1, 1, 4)))
        elif case == "rmsnorm dy shape":
            rms_mod.rmsnorm_backward_cuda(x, scale, x[:4])
        elif case == "rmsnorm d too wide":
            wide = torch.zeros((1, rms_mod.MAX_BACKWARD_D + 4))
            rms_mod.rmsnorm_backward_cuda(wide, torch.ones(wide.shape[1]), wide)
        elif case == "rmsnorm on the cpu":
            rms_mod.rmsnorm_backward_cuda(x, scale, x)
        elif case == "gating ids int64":
            gating_mod.moe_gating_backward_cuda(logits, ids.long(), dg)
        elif case == "gating dgates shape":
            gating_mod.moe_gating_backward_cuda(logits, ids, dg[:, :1])
        else:
            gating_mod.moe_gating_backward_cuda(logits, ids, dg)


def test_decode_checks_take_head_size_512_only_at_a_group_of_1_in_float32():
    kc = torch.zeros((2, 4, 32, 512))
    valid = torch.zeros((2,), dtype=torch.int32)
    dec_mod.check_inputs(torch.zeros((2, 4, 512)), kc, kc, valid)  # xLSTM's: taken
    for q, cache, cap in ((torch.zeros((2, 8, 512)), kc, 0.0),  # a group of 2
                          (torch.zeros((2, 4, 512)), kc.bfloat16(), 0.0),  # a bf16 cache
                          (torch.zeros((2, 4, 512)), kc, 2.0)):  # softcap
        with pytest.raises(ValueError, match="head_dim 512 is taken only"):
            dec_mod.check_inputs(q, cache, cache, valid, cap)


def test_build_command_targets_hopper(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    for name in _build.KERNELS:
        out = _build.library_path(name)
        cmd = _build.nvcc_command(name, out)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert {"-shared", "-O3", "-fPIC"} <= set(cmd)
        assert cmd[-1].endswith(f"csrc/{name}.cu")
        assert out.parent.name == "repro_torch_kernels" and out.parent.parent.name == "build"
        assert _build.library_path(name) == out  # keyed by content: stable
    # the four forwards, the backwards of flash attention, RMSNorm and the
    # gates, the float32 GEMM and Mamba's selective scan
    assert len({_build.library_path(n) for n in _build.KERNELS}) == len(_build.KERNELS) == 9
    assert set(_build.KERNELS) == set(ops.launch_counts())
