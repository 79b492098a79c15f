"""The flash-attention forward's host side and its wgmma route's arithmetic, on the CPU.

``flash_plan`` is the launch plan that ``flash_attention.py`` hands to the
CUDA launcher: a pure function of the shapes, the type and the card's
multiprocessor count (132 on the H100).  It is checked here for every arch
of ``configs.ARCHS`` at the serving buckets and at the training shapes
(T1: orloj_gpt at (8, 256); T2: GLM-4-9B at (2, 1024)): the block within
the card's shared memory, a whole GQA group in one block (so each K/V tile
is loaded once a KV head and query tile), a ring of at least two stages,
and the route as ``mma_sync_faster`` documents it.

The wgmma route's block is emulated in numpy, tile by tile as the kernel
walks it: the (query head, position) rows packed head-major into 64-row
slabs, every mask (causal, window, ``lengths``, the ragged tail of S), Q
and each K tile split once into TF32 parts, V split and transposed into Vᵀ
at the kernel's columns (``split_stage``'s ``col``: each 8-key group's
keys in the order 0, 2, 4, 6, 1, 3, 5, 7), P's A fragment built on its
own from the score accumulators' registers as the kernel passes them
(``make_p``) and the TF32 A fragment's layout, three TF32 passes a
product, and the tiles and k-steps a slab cannot see skipped.  A Vᵀ order
that disagrees with the A fragment then fails the emulation.  It is held
to the JAX reference and to the Pallas kernel in the Pallas interpreter
within the float32 tolerance of 2e-5 at groups of 1, 7 and 16 with
``lengths`` and a window; one TF32 pass misses that tolerance.  The two
mappings are copies of the kernel's expressions: that the kernel itself
computes what they say, only the card tests show.
"""

import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SMS = 132
F32, BF16 = torch.float32, torch.bfloat16
BUCKETS = (8, 32, 64, 128, 256)  # the engine's buckets (32 … 256) and the toy's smallest
TRAIN = {"orloj_gpt": (8, 256), "glm4_9b": (2, 1024)}  # T1's and T2's (batch, sequence)
# The column of Vᵀ that key k of an 8-key group lands in (split_stage's `col`).
VT_COL = np.array([(k >> 1) if k % 2 == 0 else 4 + (k >> 1) for k in range(8)])
# The score accumulators of a lane (g, t) for one 8-key block: register e
# holds row g + 8·(e >> 1), key 2t + (e & 1).  The kernel passes them to
# P·V in the order PASSED (make_p); A-fragment register e of the TF32
# m64nNk8 product holds row g + 8·(e & 1), column t + 4·(e >> 1).
PASSED = (0, 2, 1, 3)


def _a_fragment(p8: np.ndarray) -> np.ndarray:
    """P's (rows, 8 keys) block as the A fragment the kernel hands to P·V:
    column c of the result is the key whose score lands in column c."""
    frag = np.full_like(p8, np.nan)
    for t, e in itertools.product(range(4), range(4)):
        acc = PASSED[e]
        assert acc >> 1 == e & 1  # the register keeps its row
        frag[:, t + 4 * (e >> 1)] = p8[:, 2 * t + (acc & 1)]
    return frag


def _flash_archs():
    return [a for a in sorted(ARCHS) if get_config(a).resolved_head_dim in fa.HEAD_DIMS]


def _shapes(arch):
    seqs = [(b, s) for b, s in itertools.product((1, 8), BUCKETS)]
    return seqs + ([TRAIN[arch]] if arch in TRAIN else [])


@pytest.mark.parametrize("arch", _flash_archs())
def test_flash_plan_holds_a_whole_group_within_the_cards_limits(arch):
    cfg = get_config(arch)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    window = cfg.sliding_window or 0
    for (b, s), dtype in itertools.product(_shapes(arch), (F32, BF16)):
        p = fa.flash_plan(b, h, kv, s, hd, dtype, window, SMS)
        assert p.group == g and p.shared_bytes <= fa.MAX_SHARED
        if fa.mma_sync_faster(hd, dtype):
            assert p.route == "mma_sync" and p.heads == 1
            assert dtype == F32 and hd == 192  # where the route is built
            assert p.shared_bytes == fa.mma_sync_shared_bytes(hd, p.warps)
            continue
        assert p.route == "wgmma"
        assert p.heads == g  # every arch's group fits 64 rows: each K/V tile loaded once a KV head
        assert 1 <= p.warps <= fa.MAX_WARPGROUPS and p.rows <= 64 * p.warps
        assert p.positions == min(64 * p.warps // g, s)
        assert 2 <= p.stages <= fa.MAX_STAGES
        assert p.block_k == fa.WGMMA_BLOCK_K[dtype == F32][hd]
        assert p.shared_bytes == fa.wgmma_shared_bytes(hd, dtype == F32, p.warps, p.stages)


def test_flash_plan_routes():
    """The mma.sync route takes float32 at head size 192; the wgmma route
    every other shape: one warpgroup a block for bf16 up to head size 64,
    else two where their shared memory leaves two stages and the blocks
    cover the card."""
    p = fa.flash_plan(8, 96, 8, 256, 192, F32, 0, SMS)  # Nemotron in float32
    assert (p.route, p.warps, p.positions) == ("mma_sync", 4, 64)
    p = fa.flash_plan(8, 56, 8, 256, 128, F32, 0, SMS)  # Arctic, g 7: 126 of 128 rows
    assert (p.route, p.warps, p.heads, p.positions) == ("wgmma", 2, 7, 18)
    p = fa.flash_plan(8, 48, 1, 256, 128, F32, 0, SMS)  # Granite-34B, g 48: 96 of 128 rows
    assert (p.route, p.warps, p.heads, p.positions) == ("wgmma", 2, 48, 2)
    assert fa.flash_plan(8, 56, 8, 256, 128, BF16, 0, SMS).route == "wgmma"
    assert fa.flash_plan(8, 14, 2, 256, 64, F32, 0, SMS).route == "wgmma"  # InternVL2, g 7 at 64
    assert fa.flash_plan(4, 4, 4, 32, 16, F32, 0, SMS).route == "wgmma"
    assert fa.flash_plan(8, 32, 2, 32, 128, F32, 0, SMS).route == "wgmma"
    p = fa.flash_plan(8, 12, 12, 256, 64, F32, 0, SMS)  # orloj_gpt: 192 blocks of 128 rows
    assert (p.route, p.warps, p.heads, p.positions) == ("wgmma", 2, 1, 128)
    p = fa.flash_plan(8, 32, 32, 256, 64, BF16, 0, SMS)  # MusicGen in bf16
    assert (p.route, p.warps, p.heads, p.positions) == ("wgmma", 1, 1, 64)
    p = fa.wgmma_plan(8, 96, 8, 256, 192, F32, SMS)  # Q's two parts fill one warpgroup's room
    assert (p.warps, p.heads, p.positions, p.block_k, p.stages) == (1, 12, 5, 16, 2)
    p = fa.flash_plan(8, 96, 8, 256, 192, BF16, 0, SMS)
    assert (p.warps, p.heads, p.positions, p.block_k) == (2, 12, 10, 64)
    p = fa.flash_plan(8, 32, 2, 256, 128, F32, 0, SMS)  # GLM-4: 16-key tiles leave two warpgroups two stages
    assert (p.warps, p.heads, p.positions, p.block_k, p.stages) == (2, 16, 8, 16, 2)
    assert fa.wgmma_plan(8, 32, 2, 256, 128, F32, SMS, warpgroups=2, stages=3) is None  # 255 KB
    assert fa.wgmma_plan(8, 32, 2, 256, 128, F32, SMS, warpgroups=1, stages=1) is None  # the ring holds two


# ------------------------------------------------ the wgmma block, emulated
def _tf32(x: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 as the kernel does: to nearest, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(np.float32)


def _split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    big = _tf32(x)
    return big, _tf32(x - big)


def _product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b with TF32 parts: small·big, big·small, big·big (three passes),
    or big·big alone (one), in float32."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    if passes == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def _emulate(q, k, v, lengths, causal, window, plan, passes=3):
    """The wgmma kernel's blocks, walked as the kernel walks them; returns
    (out, lse) as the kernel writes them."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    bk, heads, positions, wgs = plan.block_k, plan.heads, plan.positions, plan.warps
    log2e = 1.4426950408889634
    scale2 = np.float32(log2e / math.sqrt(hd))
    out = np.full(q.shape, np.nan, np.float32)
    lse = np.full((b, h, s), np.nan, np.float32)
    kpad = np.zeros((b, kv, s + bk, hd), np.float32)  # TMA's zeros past S
    vpad = np.zeros_like(kpad)
    kpad[:, :, :s], vpad[:, :, :s] = k, v
    r = np.arange(64 * wgs)
    for bi, kvh, ht, qt in itertools.product(range(b), range(kv), range(g // heads), range(-(-s // positions))):
        h0, q0 = kvh * g + ht * heads, qt * positions
        len_end = s if lengths is None else min(s, max(int(lengths[bi]), 0))
        head, pos = h0 + r // positions, q0 + r % positions
        row_ok = (r < heads * positions) & (pos < s)
        qrows = np.zeros((64 * wgs, hd), np.float32)
        qrows[row_ok] = q[bi, head[row_ok], pos[row_ok]]
        k_end = min(len_end, min(q0 + positions, s)) if causal else len_end
        k_begin = max(0, q0 - window + 1) // bk * bk if window > 0 else 0
        m = np.full(64 * wgs, -1e30, np.float32)
        l = np.zeros(64 * wgs, np.float32)
        o = np.zeros((64 * wgs, hd), np.float32)
        for k0 in range(k_begin, k_end, bk):
            kt, vt = kpad[bi, kvh, k0:k0 + bk], vpad[bi, kvh, k0:k0 + bk]
            vt_perm = np.empty((hd, bk), np.float32)  # Vᵀ, each key at its column
            keys = np.arange(bk)
            vt_perm[:, (keys // 8) * 8 + VT_COL[keys % 8]] = vt.T
            for wg in range(wgs):
                rows = slice(64 * wg, 64 * wg + 64)
                ok_rows = row_ok[rows]
                if not ok_rows.any():
                    continue
                pmin, pmax = pos[rows][ok_rows].min(), pos[rows][ok_rows].max()
                slab_end = min(len_end, pmax + 1) if causal else len_end
                slab_begin = max(0, pmin - window + 1) if window > 0 else 0
                if not (k0 < slab_end and k0 + bk > slab_begin):
                    continue  # no row of the slab sees the tile
                sc = _product(qrows[rows], kt.T, passes) * scale2
                kpos = k0 + np.arange(bk)[None, :]
                p_ = pos[rows][:, None]
                mask = ok_rows[:, None] & (kpos < len_end)
                if causal:
                    mask &= kpos <= p_
                if window > 0:
                    mask &= kpos > p_ - window
                sc = np.where(mask, sc, np.float32(-1e30))
                m_new = np.maximum(m[rows], sc.max(axis=1))
                alpha = np.exp2(m[rows] - m_new)
                p = np.where(sc > -5e29, np.exp2(sc - m_new[:, None]), 0).astype(np.float32)
                m[rows] = m_new
                l[rows] = l[rows] * alpha + p.sum(axis=1)
                o[rows] *= alpha[:, None]
                for j in range(bk // 8):
                    if not (k0 + 8 * j < slab_end and k0 + 8 * j + 8 > slab_begin):
                        continue  # a k-step no row of the slab sees
                    frag = _a_fragment(p[:, 8 * j:8 * j + 8])
                    o[rows] += _product(frag, vt_perm[:, 8 * j:8 * j + 8].T, passes)
        ok = row_ok
        out[bi, head[ok], pos[ok]] = o[ok] / np.maximum(l[ok], 1e-30)[:, None]
        lse[bi, head[ok], pos[ok]] = np.where(l[ok] > 0, (m[ok] + np.log2(np.maximum(l[ok], 1e-30))) / log2e,
                                              -np.inf)
    return out, lse


CASES = [  # (b, h, kv, s, hd, lengths, window): groups of 1, 7 and 16, S not a multiple of a tile
    (2, 2, 2, 83, 32, [83, 40], 0),
    (2, 2, 2, 100, 64, [100, 0], 24),
    (1, 14, 2, 70, 64, [57], 20),
    (2, 14, 2, 45, 32, None, 16),
    (1, 16, 1, 50, 32, [33], 0),
    (2, 32, 2, 37, 16, [37, 21], 12),
]


def _inputs(b, h, kv, s, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, hd)).astype(np.float32), rng.normal(size=(b, kv, s, hd)).astype(np.float32),
            rng.normal(size=(b, kv, s, hd)).astype(np.float32))


def _jax_ref(q, k, v, lengths, window, causal=True):
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    return np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                               lengths=lens, window=window), np.float32)


@pytest.mark.parametrize("warpgroups", [1, 2])
@pytest.mark.parametrize("b,h,kv,s,hd,lengths,window", CASES)
def test_emulated_wgmma_block_matches_jax_ref(b, h, kv, s, hd, lengths, window, warpgroups):
    q, k, v = _inputs(b, h, kv, s, hd)
    plan = fa.wgmma_plan(b, h, kv, s, hd, F32, SMS, warpgroups=warpgroups)
    out, lse = _emulate(q, k, v, lengths, True, window, plan)
    assert np.isfinite(out).all() and not np.isnan(lse).any()  # every (head, position) row written once
    np.testing.assert_allclose(out, _jax_ref(q, k, v, lengths, window), rtol=2e-5, atol=2e-5)
    if lengths is not None and 0 in lengths:
        assert (out[lengths.index(0)] == 0).all() and (lse[lengths.index(0)] == -np.inf).all()


@pytest.mark.parametrize("b,h,kv,s,hd,lengths,window", [CASES[0], CASES[2], CASES[4]])
def test_emulated_wgmma_block_matches_pallas_interpreter(b, h, kv, s, hd, lengths, window):
    q, k, v = _inputs(b, h, kv, s, hd, seed=1)
    plan = fa.flash_plan(b, h, kv, s, hd, F32, window, SMS)
    out, _ = _emulate(q, k, v, lengths, True, window, plan)
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lens, window=window,
                                use_pallas=True, block_q=32, block_k=32)
    np.testing.assert_allclose(out, np.asarray(want, np.float32), rtol=2e-5, atol=2e-5)


def test_emulated_wgmma_block_noncausal_and_lse():
    """Without causality, and the LSE: the log-sum-exp of each row's scaled
    scores, against the reference's own."""
    b, h, kv, s, hd = 2, 14, 2, 40, 32
    q, k, v = _inputs(b, h, kv, s, hd, seed=2)
    lengths = [40, 9]
    plan = fa.wgmma_plan(b, h, kv, s, hd, F32, SMS, warpgroups=2)
    out, lse = _emulate(q, k, v, lengths, False, 0, plan)
    np.testing.assert_allclose(out, _jax_ref(q, k, v, lengths, 0, causal=False), rtol=2e-5, atol=2e-5)
    g = h // kv
    kr = np.repeat(k, g, axis=1)
    scores = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64), kr) / math.sqrt(hd)
    valid = np.arange(s)[None, :] < np.array(lengths)[:, None]
    scores = np.where(valid[:, None, None, :], scores, -np.inf)
    want = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1)) + scores.max(-1)
    np.testing.assert_allclose(lse, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,h,kv,s,hd,lengths,window", [CASES[1], CASES[2], CASES[4]])
def test_one_tf32_pass_in_the_emulated_block_misses_the_float32_tolerance(b, h, kv, s, hd, lengths, window):
    q, k, v = _inputs(b, h, kv, s, hd)
    plan = fa.wgmma_plan(b, h, kv, s, hd, F32, SMS, warpgroups=1)
    out, _ = _emulate(q, k, v, lengths, True, window, plan, passes=1)
    assert np.abs(out - _jax_ref(q, k, v, lengths, window)).max() > 2e-5


def test_vt_key_order_makes_the_accumulators_the_a_fragment():
    """The A fragment built from the accumulators' registers puts each key's
    score in the column where Vᵀ holds that key's row, for every key of an
    8-key block: the product P·V then pairs each score with its own V row."""
    frag_key = _a_fragment(np.arange(8, dtype=np.float32)[None, :])[0].astype(int)
    vt_key = np.empty(8, int)
    vt_key[VT_COL] = np.arange(8)
    assert (frag_key == vt_key).all()
    assert sorted(VT_COL) == list(range(8))
