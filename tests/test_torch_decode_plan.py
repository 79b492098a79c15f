"""The decode kernel's host side and its tensor-core arithmetic, on the CPU.

``decode_plan`` is the launch plan that ``decode_attention.py`` hands to the
CUDA launcher: a pure function of the shapes, the types and the card's
multiprocessor count (132 on the H100).  It is checked here for every arch
of ``configs.ARCHS`` at B 1, 8 and 128 and at the cache lengths the models
serve: each cache element read once, the block within the card's shared
memory and cluster limits, the tensor cores taking every group above 4,
several warps a block at head size 512, and a ring deep enough for the
keys a block walks.

The tensor-core route's arithmetic is emulated in plain torch (``_tf32``):
over a float32 cache three TF32 passes a product; over a bfloat16 cache
bf16 products with the float32 queries and probabilities split into three
bf16 parts (the cache's values are bf16 already), and with bf16 queries
one part (P rounded to bf16 once).  The emulations are held to the JAX
reference at GLM-4-9B's group of 16 and Granite-34B's of 48; one TF32
pass, and one bf16 part, miss the float32 tolerance of 2e-5."""

import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _tf32 import bf16_split_matmul, tf32_matmul  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402

SMS = 132
F32, BF16 = torch.float32, torch.bfloat16
BATCHES = (1, 8, 128)
# Cache lengths: S < one tile, the kernel table's 256, 1024 (Hymba's ring), 4096,
# decode_32k's 32,768 and long_500k's 8,192-slot window.
SEQS = (7, 256, 1024, 4096, SHAPES["decode_32k"].seq_len, 8192)


def _pairs(hd: int):
    return [(F32, F32)] if hd == dec.WIDE_HEAD_DIM else list(dec.PAIRS)


def _decode_archs():
    return [a for a in sorted(ARCHS) if get_config(a).resolved_head_dim in dec.HEAD_DIMS]


@pytest.mark.parametrize("arch", _decode_archs())
def test_decode_plan_reads_the_cache_once_within_the_cards_limits(arch):
    cfg = get_config(arch)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    for b, s, (qt, ct) in itertools.product(BATCHES, SEQS, _pairs(hd)):
        p = dec.decode_plan(b, h, kv, s, hd, qt, ct, SMS)
        assert p.group == g and p.cache_reads == 1
        assert p.shared_bytes <= dec.MAX_SHARED
        assert 1 <= p.cluster <= dec.MAX_CLUSTER
        assert 1 <= p.warps <= 8
        if hd == dec.WIDE_HEAD_DIM:
            assert p.route == "wide" and p.warps > 1
        else:
            assert (p.route == "tensor_cores") == (g > 4)
        if p.route == "tensor_cores":  # the whole group in one block's M tiles
            assert p.heads == 16 * p.m_tiles >= g > 16 * (p.m_tiles - 1)
            assert p.warps % p.m_tiles == 0 and p.stage_keys == dec.TC_KEYS * p.warps // p.m_tiles
        elif p.route == "simt":
            assert p.heads in (1, 2, 4) and p.heads >= g and p.warps == p.heads * p.stages
        # A ring of one stage serves only a block whose keys fit one stage.
        per = -(-s // p.cluster)
        if p.route != "simt":
            assert 1 <= p.stages <= 4
            assert p.stages >= 2 or per <= p.stage_keys


def test_decode_plan_at_the_documented_shapes():
    """PERF.md's plans: orloj_gpt's step on the SIMT route as before (8
    slots of one warp, one block a row and head); GLM-4-9B over its bf16
    cache at 4,096 slots, 4 key warps of one M tile and a 2-stage ring in
    91,520 bytes, so that two blocks fit an SM and its 16 clusters of 8 fit
    the card at once; Granite's g 48 in 3 M tiles of 2 key warps; Nemotron's
    g 12 at head size 192 in clusters of 2 (its 64 pairs cover the SMs);
    xLSTM's head size 512 on 4 warps, 2 stages, 8 blocks."""
    p = dec.decode_plan(8, 12, 12, 256, 64, F32, F32, SMS)
    assert (p.route, p.heads, p.warps, p.stages, p.cluster) == ("simt", 1, 8, 8, 1)
    assert p.dynamic_bytes == 139_264
    p = dec.decode_plan(8, 32, 2, 4096, 128, F32, BF16, SMS)
    assert (p.route, p.m_tiles, p.warps, p.stages, p.stage_keys, p.cluster) == ("tensor_cores", 1, 4, 2, 64, 8)
    assert p.shared_bytes == 91_520 <= dec.TWO_A_SM
    p = dec.decode_plan(4, 48, 1, 4096, 128, F32, F32, SMS)
    assert (p.route, p.m_tiles, p.warps, p.stages, p.cluster) == ("tensor_cores", 3, 6, 4, 8)
    p = dec.decode_plan(8, 96, 8, 256, 192, F32, F32, SMS)
    assert (p.route, p.m_tiles, p.warps, p.stages, p.cluster) == ("tensor_cores", 1, 2, 3, 2)
    p = dec.decode_plan(8, 4, 4, 256, 512, F32, F32, SMS)
    assert (p.route, p.warps, p.stages, p.stage_keys, p.cluster) == ("wide", 4, 2, 8, 8)
    # The cluster follows the card: on 4 multiprocessors GLM-4's 16 (row,
    # KV head) pairs take one block each.
    assert dec.decode_plan(8, 32, 2, 4096, 128, F32, BF16, 4).cluster == 1


def test_groups_above_the_largest_are_refused():
    q = torch.zeros((1, 2 * dec.MAX_GROUP, 64))
    kc = torch.zeros((1, 1, 8, 64))
    dec.check_inputs(q[:, : dec.MAX_GROUP], kc, kc, torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="at most"):
        dec.check_inputs(q, kc, kc, torch.ones((1,), dtype=torch.int32))


# ------------------------------------------------ the tensor-core arithmetic
def _tc_decode(q, k, v, valid, cache: str, passes: int) -> torch.Tensor:
    """Decode attention with the tensor-core route's arithmetic: the group's
    products (over a float32 cache ``passes`` TF32 passes, over a bf16 cache
    the float32 operand in ``passes`` bf16 parts), the scale after Q·Kᵀ,
    unnormalised probabilities into P·V, one division at the end; rows with
    no valid key give 0."""
    b, h, hd = q.shape
    kv, s = k.shape[1], k.shape[2]
    product = tf32_matmul if cache == "float32" else bf16_split_matmul
    qg = q.reshape(b, kv, h // kv, hd)
    scores = product(qg, k.transpose(-1, -2), passes) / math.sqrt(hd)
    mask = (torch.arange(s)[None] < valid[:, None])[:, None, None]
    scores = torch.where(mask, scores, -1e30)
    p = torch.where(mask, torch.exp(scores - scores.amax(-1, keepdim=True)), 0.0)
    out = product(p, v, passes) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, hd)


def _inputs(b, h, kv, s, hd, cache: str):
    """numpy inputs from a seed as (jax, torch float32) pairs; a bf16 cache
    is rounded to bf16 on both sides (the torch side holds its values in
    float32, as the kernel does once it has read them)."""
    rng = np.random.default_rng(23)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, kv, s, hd)).astype(np.float32) for _ in range(2))
    jd = jnp.bfloat16 if cache == "bfloat16" else jnp.float32
    jk, jv = jnp.asarray(k, jd), jnp.asarray(v, jd)
    tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))) for x in (jk, jv))
    valid = np.array([s, s // 3 + 1][:b], np.int32)
    return (jnp.asarray(q), jk, jv, jnp.asarray(valid)), (torch.from_numpy(q), tk, tv, torch.from_numpy(valid))


GROUPS = [(2, 32, 2, 256, 128), (2, 48, 1, 256, 128)]  # GLM-4-9B's g 16, Granite-34B's g 48


@pytest.mark.parametrize("b,h,kv,s,hd", GROUPS)
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_split_tf32_decode_matches_jax_ref(b, h, kv, s, hd, cache):
    """Float32 queries: three TF32 passes over a float32 cache, three bf16
    parts over a bf16 cache."""
    jin, tin = _inputs(b, h, kv, s, hd, cache)
    want = np.asarray(jref.decode_attention_ref(*jin), np.float32)
    got = _tc_decode(*tin, cache=cache, passes=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,h,kv,s,hd", GROUPS)
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_one_tf32_pass_misses_the_float32_tolerance_in_decode(b, h, kv, s, hd, cache):
    """One TF32 pass over a float32 cache, and one bf16 part over a bf16
    cache, miss 2e-5.  (Two bf16 parts, 16 bits, reach 3.0e-5 at Granite's
    g 48 with queries 4 times larger: the kernel takes three.)"""
    jin, tin = _inputs(b, h, kv, s, hd, cache)
    want = np.asarray(jref.decode_attention_ref(*jin), np.float32)
    err = np.abs(_tc_decode(*tin, cache=cache, passes=1).numpy() - want).max()
    assert err > 2e-5


@pytest.mark.parametrize("b,h,kv,s,hd", GROUPS)
def test_one_bf16_part_holds_the_bf16_tolerance_over_bf16(b, h, kv, s, hd):
    """bf16 queries over a bf16 cache: q is one bf16 part (exact), P is
    rounded to bf16 once, as the plain version rounds it; the bf16 output
    holds the reference to 2e-2."""
    jin, tin = _inputs(b, h, kv, s, hd, "bfloat16")
    jq = jin[0].astype(jnp.bfloat16)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32)))
    want = np.asarray(jref.decode_attention_ref(jq, *jin[1:]).astype(jnp.float32))
    got = _tc_decode(tq, *tin[1:], cache="bfloat16", passes=1).to(BF16).float()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
