"""The port's SSM, recurrent and frontend models against the JAX reference,
on the CPU: Hymba-1.5B, xLSTM-1.3B, InternVL2-1B and MusicGen-large at
``.reduced()`` widths.

Weights are drawn by the reference's ``Model.init`` and converted
(``repro_torch.models.convert``); inputs are numpy, seeded: tokens, a vision
prefix of patch embeddings, or audio frame embeddings.  Held: the logits of
the forward, the decode steps with their caches (MusicGen also computing in
bfloat16), Hymba's decode ≡ forward past its sliding window, and the
conversion of scanned stacks (xLSTM's units of ``slstm_every`` blocks,
Hymba's single-block units) and of the SSM caches, both ways.

Tolerances: 2e-5 (``LOGITS_TOL``) where the port computes in the
reference's order; 1e-4 for a model with Mamba heads, whose chunk scan is
associated in another order; 5e-2 in bfloat16 (the bound of the
reference's own decode test, ``test_arch_smoke.py``), relative to the
largest logit where that exceeds 1.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    cache_from_numpy,
    cache_to_numpy,
    from_numpy,
    scan_unit,
)

LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 5e-2
ZOO = ["hymba_1_5b", "xlstm_1_3b", "internvl2_1b", "musicgen_large"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tol(cfg, dtype: str) -> dict:
    if dtype == "bfloat16":
        return dict(rtol=BF16_TOL, atol=BF16_TOL)
    return SCAN_TOL if cfg.block_pattern == "hymba" else LOGITS_TOL


def _close(got: torch.Tensor, want, tol: dict):
    """``want`` (a JAX array) against the port's tensor, both read in
    float32; the absolute bound scales with the largest logit above 1."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol["rtol"], atol=tol["atol"] * scale)


def _batch(cfg, rng, seq: int = 24):
    """The reference's and the port's batch for one forward: tokens, a
    vision prefix of n_frontend_tokens patch embeddings before the tokens,
    or audio frame embeddings in place of tokens."""
    b: dict = {}
    if cfg.frontend == "audio":
        b["frontend_embeds"] = rng.normal(size=(2, seq, 512)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, size=(2, seq))
        if cfg.frontend == "vision":
            b["frontend_embeds"] = rng.normal(size=(2, cfg.n_frontend_tokens, 1024)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}


def _pair(cfg, seed: int):
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    return jm, jparams, Model(cfg, device="cpu"), from_numpy(_np_tree(jparams), cfg, device="cpu")


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ZOO]
                         + [("musicgen_large", "bfloat16"), ("internvl2_1b", "bfloat16")])
def test_model_logits_match_jax(arch, dtype):
    """The forward over each model's own inputs.  In bfloat16, MusicGen's
    frames skip the token embedding and the stack computes in bfloat16;
    InternVL2's prefix is projected in bfloat16 and joined to the float32
    tokens, which promotes the rest to float32."""
    cfg = get_config(arch).reduced(dtype=dtype)
    jm, jparams, tm, tparams = _pair(cfg, 50)
    jbatch, tbatch = _batch(cfg, np.random.default_rng(50))
    with torch.no_grad():
        got = tm.logits(tparams, tbatch)
    want = jm.logits(jparams, jbatch)
    assert got.shape == want.shape
    assert got.dtype == getattr(torch, str(want.dtype))
    if arch == "musicgen_large":
        assert got.dtype == getattr(torch, dtype)
    _close(got, want, _tol(cfg, dtype))


def test_musicgen_decode_steps_match_jax_in_bfloat16():
    """Eight audio decode steps computing in bfloat16 over the default
    bfloat16 cache: the logits after each and the cache after the last."""
    cfg = get_config("musicgen_large").reduced(dtype="bfloat16")
    jm, jparams, tm, tparams = _pair(cfg, 51)
    jcache, tcache = jm.init_cache(2, cache_len=16), tm.init_cache(2, 16)
    frames = np.random.default_rng(51).normal(size=(2, 8, 512)).astype(np.float32)
    step = jax.jit(jm.decode_step)
    for i in range(8):
        want, jcache = step(jparams, jnp.asarray(frames[:, i : i + 1]), jcache, jnp.int32(i))
        with torch.no_grad():
            got, tcache = tm.decode_step(tparams, torch.from_numpy(frames[:, i : i + 1]), tcache, i)
        assert got.dtype == torch.bfloat16 and got.shape == (2, 1, cfg.vocab_size)
        _close(got, want, _tol(cfg, "bfloat16"))
    for g, w in zip(jax.tree.leaves(cache_to_numpy(tcache, cfg)), jax.tree.leaves(jcache), strict=True):
        _close(torch.from_numpy(g), w, _tol(cfg, "bfloat16"))


def test_hymba_decode_matches_forward_past_the_window():
    """Hymba at .reduced() has a 64-token window: over 80 tokens the forward
    cuts keys at kpos <= qpos − 64 and the decode ring (64 slots) wraps at
    step 64.  The port's forward against the reference's, its decode steps
    against the reference's steps, and its decode against its forward."""
    cfg = get_config("hymba_1_5b").reduced()
    assert cfg.sliding_window == 64
    jm, jparams, tm, tparams = _pair(cfg, 52)
    tokens = np.random.default_rng(52).integers(0, cfg.vocab_size, size=(2, 80))
    with torch.no_grad():
        full = tm.logits(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(full, jm.logits(jparams, {"tokens": jnp.asarray(tokens)}), SCAN_TOL)
    jcache, tcache = jm.init_cache(2, cache_len=128, dtype=jnp.float32), tm.init_cache(2, 128, torch.float32)
    assert tcache[0]["kv"]["k"].shape[2] == 64
    step = jax.jit(jm.decode_step)
    steps = []
    for i in range(80):
        want, jcache = step(jparams, jnp.asarray(tokens[:, i : i + 1]), jcache, jnp.int32(i))
        with torch.no_grad():
            got, tcache = tm.decode_step(tparams, torch.from_numpy(tokens[:, i : i + 1]), tcache, i)
        _close(got, want, SCAN_TOL)
        steps.append(got[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), **SCAN_TOL)
    for g, w in zip(jax.tree.leaves(cache_to_numpy(tcache, cfg)), jax.tree.leaves(jcache), strict=True):
        _close(torch.from_numpy(g), w, SCAN_TOL)


@pytest.mark.parametrize("arch", ZOO)
def test_init_draws_the_reference_shapes(arch):
    """``Model.init`` draws the reference's tree (no token embedding for
    audio, ``frontend_proj`` of 1024 or 512 rows for a frontend), flat."""
    cfg = get_config(arch).reduced()
    jshapes = jax.eval_shape(JaxModel(cfg).init, jax.random.PRNGKey(0))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tshapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert tshapes == jax.tree.map(lambda s: tuple(s.shape), jshapes)
    assert ("embed" in params) == (cfg.frontend != "audio")
    if cfg.frontend:
        assert params["frontend_proj"].shape == (Model(cfg, device="cpu").frontend_dim, cfg.d_model)


SCANNED = [
    ("xlstm_1_3b", dict(n_layers=4, slstm_every=2, scan_layers=True), 2),  # 2 units of 2 blocks
    ("hymba_1_5b", dict(n_layers=3, scan_layers=True), 1),
    ("xlstm_1_3b", dict(n_layers=3, slstm_every=2, scan_layers=True), 0),  # 3 ∤ 2: unrolled
]


@pytest.mark.parametrize("arch,change,unit", SCANNED)
def test_convert_round_trips_scanned_ssm_stacks(arch, change, unit):
    """The reference's scanned parameters and cache (layer u·unit + i is
    entry i, row u) into the port's flat lists and the cache back, bit for
    bit; the SSM states keep their layout, only the KV caches turn.  The
    converted model and cache then step as the reference does."""
    cfg = get_config(arch).reduced(**change)
    assert scan_unit(cfg) == unit
    jm, jparams, tm, tparams = _pair(cfg, 53)
    assert len(jparams["blocks"]) == (unit or cfg.n_layers) and len(tparams["blocks"]) == cfg.n_layers
    jcache = jm.init_cache(2, cache_len=8, dtype=jnp.float32)
    rng = np.random.default_rng(53)
    jcache = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jcache)
    tcache = cache_from_numpy(_np_tree(jcache), cfg, device="cpu")
    for layer in range(cfg.n_layers):
        entry, row = (jcache[layer % unit], layer // unit) if unit else (jcache[layer], None)
        for part, leaves in tcache[layer].items():
            for k, t in leaves.items():
                ref = np.asarray(entry[part][k]) if row is None else np.asarray(entry[part][k])[row]
                if part == "kv":
                    ref = ref.swapaxes(1, 2)
                np.testing.assert_array_equal(t.numpy(), ref)
    back = cache_to_numpy(tcache, cfg)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jcache), strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))
    tokens = np.random.default_rng(54).integers(0, cfg.vocab_size, size=(2, 1))
    want, jcache = jm.decode_step(jparams, jnp.asarray(tokens), jcache, jnp.int32(3))
    with torch.no_grad():
        got, tcache = tm.decode_step(tparams, torch.from_numpy(tokens), tcache, 3)
    _close(got, want, _tol(cfg, "float32"))
    for g, w in zip(jax.tree.leaves(cache_to_numpy(tcache, cfg)), jax.tree.leaves(jcache), strict=True):
        _close(torch.from_numpy(g), w, _tol(cfg, "float32"))


def test_convert_rejects_a_stack_of_the_wrong_unit():
    cfg = get_config("xlstm_1_3b").reduced(n_layers=4, slstm_every=2, scan_layers=True)
    jparams = _np_tree(JaxModel(cfg).init(jax.random.PRNGKey(55)))
    with pytest.raises(ValueError, match="one unit of 2 blocks"):
        from_numpy(dict(jparams, blocks=jparams["blocks"][:1]), cfg, device="cpu")
    flat = dataclasses.replace(cfg, scan_layers=False)
    with pytest.raises(ValueError, match="expected 4 per-layer dicts"):
        from_numpy(jparams, flat, device="cpu")
