"""The port's SSM and recurrent cells and blocks against the JAX reference,
on the CPU.

``repro_torch.models.ssm`` (Mamba, mLSTM, sLSTM) and the Hymba and xLSTM
branches of ``repro_torch.models.blocks`` are held against
``repro.models.ssm`` / ``repro.models.blocks`` on the same weights (drawn by
the reference's ``init_*`` and converted) and the same inputs (numpy,
seeded): the full-sequence apply at lengths that span several chunks and at
one that no chunk divides, each decode step with its state, and, on the port
alone, the chunked apply against stepping the decode.

Tolerances: 2e-5 (``LOGITS_TOL`` of the model tests) where the port computes
in the reference's order (mLSTM's chunks, sLSTM's steps, the decode steps);
1e-4 where the order differs: Mamba's chunk scan (a doubling scan in place
of ``lax.associative_scan``'s tree) and the chunked forms against the
step-by-step recurrence.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import blocks as jb  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
D, N_STATE, HEADS, CHUNK = 64, 16, 4, 8
# Several chunks of 8; 30 takes chunks of 6 (rounded down to a divisor).
LENGTHS = [32, 30]


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(rng, shape, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _close_state(got: dict, want: dict, tol):
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        _close(got[k], want[k], tol)


CELLS = {
    # name: (reference init, port apply, reference apply, tolerance of the apply)
    "mamba": (lambda k: jssm.init_mamba(k, D, N_STATE),
              lambda p, x: ssm.mamba_apply(p, x, CHUNK),
              lambda p, x: jssm.mamba_apply(p, x, CHUNK), SCAN_TOL),
    "mlstm": (lambda k: jssm.init_mlstm(k, D, HEADS),
              lambda p, x: ssm.mlstm_apply(p, x, CHUNK),
              lambda p, x: jssm.mlstm_apply(p, x, CHUNK), LOGITS_TOL),
    "slstm": (lambda k: jssm.init_slstm(k, D, HEADS),
              lambda p, x: ssm.slstm_apply(p, x, HEADS),
              lambda p, x: jssm.slstm_apply(p, x, HEADS), LOGITS_TOL),
}


def _decode_fns(name):
    if name == "mamba":
        return (lambda b: ssm.init_mamba_cache(b, D, N_STATE, device="cpu"),
                lambda b: jssm.init_mamba_cache(b, D, N_STATE), ssm.mamba_decode, jssm.mamba_decode)
    if name == "mlstm":
        return (lambda b: ssm.init_mlstm_cache(b, D, HEADS, device="cpu"),
                lambda b: jssm.init_mlstm_cache(b, D, HEADS), ssm.mlstm_decode, jssm.mlstm_decode)
    return (lambda b: ssm.init_slstm_cache(b, D, device="cpu"),
            lambda b: jssm.init_slstm_cache(b, D),
            lambda p, x, c: ssm.slstm_decode(p, x, c, HEADS),
            lambda p, x, c: jssm.slstm_decode(p, x, c, HEADS))


def _params(name, seed):
    jparams = CELLS[name][0](jax.random.PRNGKey(seed))
    return jparams, _t(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("name", list(CELLS))
def test_cell_apply_matches_jax(name, s):
    _, port_apply, ref_apply, tol = CELLS[name]
    jparams, tparams = _params(name, 40)
    jx, tx = _x(np.random.default_rng(40 + s), (2, s, D))
    with torch.no_grad():
        got = port_apply(tparams, tx)
    want = ref_apply(jparams, jx)
    assert got.shape == (2, s, D) and got.dtype == torch.float32
    _close(got, want, tol)


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_decode_matches_jax(name):
    """Six steps: the output and the whole state after each; the port's
    state is updated in place."""
    t_cache, j_cache, t_decode, j_decode = _decode_fns(name)
    jparams, tparams = _params(name, 41)
    tc, jc = t_cache(2), j_cache(2)
    leaves = {k: v for k, v in tc.items()}
    rng = np.random.default_rng(41)
    for _ in range(6):
        jx, tx = _x(rng, (2, 1, D))
        with torch.no_grad():
            got, tc2 = t_decode(tparams, tx, tc)
        want, jc = j_decode(jparams, jx, jc)
        assert tc2 is tc and all(tc[k] is leaves[k] for k in tc)
        _close(got, want, LOGITS_TOL)
        _close_state(tc, jc, LOGITS_TOL)


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("name", list(CELLS))
def test_chunked_apply_is_the_stepped_decode(name, s):
    """The port alone: the full-sequence form (chunks of 8, or of 6 at
    length 30) gives what stepping the decode over the same tokens gives."""
    t_cache, _, t_decode, _ = _decode_fns(name)
    _, port_apply, _, _ = CELLS[name]
    _, tparams = _params(name, 42)
    _, tx = _x(np.random.default_rng(42 + s), (2, s, D))
    cache = t_cache(2)
    with torch.no_grad():
        full = port_apply(tparams, tx)
        steps = torch.cat([t_decode(tparams, tx[:, i : i + 1], cache)[0] for i in range(s)], 1)
    _close(steps, full.numpy(), SCAN_TOL)


def test_chunk_len_rounds_down_to_a_divisor():
    assert [ssm._chunk_len(s, 8) for s in (32, 30, 13, 5)] == [8, 6, 1, 5]


def test_scan_reaches_full_decay_without_underflow_faults():
    """a = e^(−16·dt) over a long chunk: the products underflow to 0, which
    the doubling scan carries as it is (no division by a cumulative
    product), so the states stay finite and equal the sequential recurrence."""
    rng = np.random.default_rng(43)
    a = torch.from_numpy(np.exp(-16 * rng.uniform(0.5, 4, size=(2, 64, 3, 4))).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 64, 3, 4)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32))
    got = ssm._mamba_scan(a, b, h0, 32)
    h, want = h0, []
    for t in range(64):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    assert bool(torch.isfinite(got).all())
    _close(got, torch.stack(want, 1).numpy(), SCAN_TOL)


def test_mamba_init_draws_only_the_random_leaves():
    """The constant leaves are the reference's constants; the random ones
    have its shapes and scales."""
    gen = torch.Generator().manual_seed(44)
    p = ssm.init_mamba(gen, D, N_STATE)
    want = jssm.init_mamba(jax.random.PRNGKey(44), D, N_STATE)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in want.items()}
    for k in ("dt_bias", "d_skip"):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(want[k]))
    # log(1..N): torch's and XLA's log may differ in the last bit
    np.testing.assert_allclose(p["a_log"].numpy(), np.asarray(want["a_log"]), rtol=2**-23, atol=0)
    assert abs(p["conv"].std().item() - 0.5) < 0.1


# ----------------------------------------------------------------- blocks
BLOCKS = [("hymba_1_5b", 0), ("xlstm_1_3b", 0), ("xlstm_1_3b", 1)]  # hymba, mlstm, slstm


@pytest.mark.parametrize("arch,layer", BLOCKS)
def test_block_apply_matches_jax(arch, layer):
    """A Hymba block (attention ∥ Mamba, the rmsnorm mix, the SwiGLU) over
    S 40 (chunks of 32 rounded to 20), and xLSTM's mLSTM and sLSTM blocks."""
    cfg = get_config(arch).reduced()
    assert tb.block_kind(cfg, layer) == jb.block_kind(cfg, layer)
    jparams = jb.init_block(jax.random.PRNGKey(45), cfg, layer)
    tparams = _t(jax.tree.map(np.asarray, jparams))
    jx, tx = _x(np.random.default_rng(45), (2, 40, cfg.d_model))
    with torch.no_grad():
        got, aux = tb.block_apply(tparams, tx, cfg, layer)
    want, jaux = jb.block_apply(jparams, jx, cfg, layer)
    _close(got, want, SCAN_TOL if arch == "hymba_1_5b" else LOGITS_TOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch,layer", BLOCKS)
def test_block_decode_matches_jax(arch, layer):
    """Five steps of each kind: the output and every leaf of the cache."""
    cfg = get_config(arch).reduced()
    jparams = jb.init_block(jax.random.PRNGKey(46), cfg, layer)
    tparams = _t(jax.tree.map(np.asarray, jparams))
    jcache = jb.init_block_cache(cfg, layer, 2, 8, jnp.float32)
    tcache = tb.init_block_cache(cfg, layer, 2, 8, torch.float32, device="cpu")
    assert set(tcache) == set(jcache)
    rng = np.random.default_rng(46)
    for pos in range(5):
        jx, tx = _x(rng, (2, 1, cfg.d_model))
        with torch.no_grad():
            got, tcache = tb.block_decode(tparams, tx, tcache, pos, cfg, layer)
        want, jcache = jb.block_decode(jparams, jx, jcache, jnp.int32(pos), cfg, layer)
        _close(got, want, LOGITS_TOL)
        for part in tcache:
            for k, leaf in tcache[part].items():
                ref = np.asarray(jcache[part][k])
                if part == "kv":  # the port's (B, KV, S, hd), the reference's (B, S, KV, hd)
                    leaf = leaf.transpose(1, 2)
                _close(leaf, ref, LOGITS_TOL)


def test_block_caches_hold_the_ssm_states_in_float32():
    cfg = get_config("hymba_1_5b").reduced()
    c = tb.init_block_cache(cfg, 0, 2, 200, torch.bfloat16, device="cpu")
    assert c["kv"]["k"].shape == (2, cfg.n_kv_heads, cfg.sliding_window, 64)
    assert c["kv"]["k"].dtype == torch.bfloat16
    assert {k: (tuple(v.shape), v.dtype) for k, v in c["mamba"].items()} == {
        "h": ((2, cfg.d_model, cfg.ssm_state), torch.float32),
        "conv": ((2, 3, cfg.d_model), torch.float32),
    }
    x = get_config("xlstm_1_3b").reduced()
    assert set(tb.init_block_cache(x, 0, 2, 8, device="cpu")["cell"]) == {"c", "n"}
    assert set(tb.init_block_cache(x, 1, 2, 8, device="cpu")["cell"]) == {"h", "c", "n"}


def test_ssm_caches_default_to_the_card():
    """Like every entry point of the port, the state allocators take the
    CPU only on request: without a card, the default raises."""
    for make in (lambda: ssm.init_mamba_cache(1, 8, 4), lambda: ssm.init_mlstm_cache(1, 8, 2),
                 lambda: ssm.init_slstm_cache(1, 8)):
        if torch.cuda.is_available():
            assert all(t.device.type == "cuda" for t in make().values())
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
