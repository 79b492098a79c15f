"""The port's model layers and model against the JAX reference, on the CPU.

Parameters are drawn by the reference's ``init_*`` / ``Model.init`` and
handed to the port as numpy arrays; inputs come from numpy with a seed.
Tolerances: 1e-5 for single layers in float32 (the frameworks sum matrix
products in another order; values are O(1)); 2e-5 for whole-model logits
of magnitude ~4 (the same rounding, accumulated over the layers and the
d-wide head; 3e-6 was seen at full width).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.orloj_gpt import CONFIG as JAX_ORLOJ_GPT  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.convert import from_numpy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm", "nonparam_ln"])
def test_norm_apply(kind):
    rng = np.random.default_rng(0)
    jx, tx = _x(rng, (2, 8, 48))
    params = {}
    if kind != "nonparam_ln":
        params["scale"] = rng.normal(size=48).astype(np.float32)
    if kind == "layernorm":
        params["bias"] = rng.normal(size=48).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = jl.norm_apply(jp, jx * 3 + 1, kind)
    got = tl.norm_apply(_t(params), tx * 3 + 1, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_rotates_halves_like_the_reference():
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, (2, 40, 3, 16))
    jsin, jcos = jl.rope_tables(jnp.arange(40)[None, :], 16, 10_000.0)
    tsin, tcos = tl.rope_tables(torch.arange(40)[None, :], 16, 10_000.0)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), **TOL)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), **TOL)
    want = jl.rope_apply(jx, jsin, jcos)
    got = tl.rope_apply(tx, tsin, tcos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_heads,n_kv,window", [(4, 4, 0), (4, 2, 0), (4, 1, 16)])
def test_attention_apply(n_heads, n_kv, window):
    d, hd, s = 64, 32, 48
    params = _np_tree(jl.init_attention(jax.random.PRNGKey(3), d, n_heads, n_kv, hd))
    rng = np.random.default_rng(3)
    jx, tx = _x(rng, (2, s, d))
    want = jl.attention_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jx,
        n_kv=n_kv, rope_theta=10_000.0, sliding_window=window,
    )
    got = tl.attention_apply(_t(params), tx, n_kv=n_kv, rope_theta=10_000.0, sliding_window=window)
    assert got.shape == (2, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("option", ["softcap", "repeat_kv"])
def test_attention_options_not_ported_raise(option):
    params = _t(_np_tree(jl.init_attention(jax.random.PRNGKey(4), 32, 2, 2, 16)))
    kw = {"softcap": 30.0} if option == "softcap" else {"repeat_kv": True}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.attention_apply(params, torch.zeros((1, 4, 32)), n_kv=2, rope_theta=1e4, **kw)


@pytest.mark.parametrize("kind", ["gelu", "swiglu", "relu2"])
def test_mlp_apply(kind):
    params = _np_tree(jl.init_mlp(jax.random.PRNGKey(5), 48, 96, kind))
    rng = np.random.default_rng(5)
    jx, tx = _x(rng, (2, 8, 48))
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in params.items()}, jx, kind)
    got = tl.mlp_apply(_t(params), tx, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_clamps_out_of_range_ids_like_jax():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[1, 5, -1, 999]])
    want = jl.embed_apply({"table": jnp.asarray(table)}, jnp.asarray(ids), jnp.float32)
    got = tl.embed_apply({"table": torch.from_numpy(table)}, torch.from_numpy(ids), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _logits_pair(cfg: ModelConfig, tokens: np.ndarray, seed: int):
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    want = np.asarray(jm.logits(jparams, {"tokens": jnp.asarray(tokens)}))
    tm = Model(cfg, device="cpu")
    tparams = from_numpy(_np_tree(jparams), cfg, device="cpu")
    with torch.no_grad():
        got = tm.logits(tparams, {"tokens": torch.from_numpy(tokens.astype(np.int64))})
    return got, want


def test_config_copy_matches_the_reference():
    assert dataclasses.asdict(get_config("orloj_gpt")) == dataclasses.asdict(JAX_ORLOJ_GPT)


def test_model_logits_reduced_orloj_gpt():
    """The toy orloj_gpt (2 layers, d 256, f32, unscanned per-layer list)."""
    cfg = get_config("orloj_gpt").reduced()
    assert not cfg.scan_layers and cfg.dtype == "float32"
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 24))
    got, want = _logits_pair(cfg, tokens, seed=6)
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_model_logits_tied_head():
    """A tied head goes through unembed_apply against the embedding table."""
    cfg = get_config("orloj_gpt").reduced(tie_embeddings=True, n_layers=1)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(2, 16))
    got, want = _logits_pair(cfg, tokens, seed=9)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_model_logits_full_width_scanned_stack():
    """Full orloj_gpt width (d 768, 12 heads, d_ff 3072) at 2 layers with the
    scanned layout that convert.py unstacks.  The config's dtype is bfloat16,
    yet the reference computes in float32 (bf16 embedding × f32 √d promotes),
    and the port must too."""
    cfg = dataclasses.replace(get_config("orloj_gpt"), n_layers=2, vocab_size=512)
    assert cfg.scan_layers and cfg.dtype == "bfloat16" and cfg.d_model == 768
    tokens = np.random.default_rng(7).integers(0, 512, size=(2, 40))
    got, want = _logits_pair(cfg, tokens, seed=7)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_convert_unstacks_the_scanned_layout():
    cfg = dataclasses.replace(
        get_config("orloj_gpt"), n_layers=3, vocab_size=64, d_model=96, n_heads=4, n_kv_heads=4, d_ff=128
    )
    jparams = _np_tree(JaxModel(cfg).init(jax.random.PRNGKey(8)))
    assert len(jparams["blocks"]) == 1 and jparams["blocks"][0]["attn"]["wq"].shape == (3, 96, 4, 24)
    params = from_numpy(jparams, cfg, device="cpu")
    assert len(params["blocks"]) == 3
    for i, bp in enumerate(params["blocks"]):
        np.testing.assert_array_equal(bp["attn"]["wq"].numpy(), jparams["blocks"][0]["attn"]["wq"][i])
        assert bp["mlp"]["w_up"].shape == (96, 128)
    with pytest.raises(ValueError, match="one unit"):
        from_numpy({**jparams, "blocks": jparams["blocks"] * 2}, cfg, device="cpu")


def test_model_init_draws_the_reference_shapes_and_scales():
    cfg = get_config("orloj_gpt").reduced(n_layers=2)
    jshapes = jax.tree.map(lambda a: a.shape, JaxModel(cfg).init(jax.random.PRNGKey(0)))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tshapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert tshapes == jax.tree.map(tuple, jshapes, is_leaf=lambda x: isinstance(x, tuple))
    wq = params["blocks"][0]["attn"]["wq"]
    assert abs(wq.std().item() - 1 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)
    again = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["lm_head"], params["lm_head"])
    assert Model.param_count(params) == sum(int(np.prod(s)) for s in jax.tree.leaves(
        jshapes, is_leaf=lambda x: isinstance(x, tuple)))


@pytest.mark.parametrize("arch_change", [{"n_experts": 4, "top_k": 2}, {"block_pattern": "hymba"},
                                         {"block_pattern": "xlstm"}])
def test_blocks_not_ported_raise(arch_change):
    cfg = dataclasses.replace(get_config("orloj_gpt").reduced(), **arch_change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, device="cpu")
