"""The port's model layers and model against the JAX reference, on the CPU.

Parameters are drawn by the reference's ``init_*`` / ``Model.init`` and
handed to the port as numpy arrays; inputs come from numpy with a seed.
Tolerances: 1e-5 for single layers in float32 (the frameworks sum matrix
products in another order; values are O(1)); 2e-5 for whole-model logits
of magnitude ~4 (the same rounding, accumulated over the layers and the
d-wide head; 3e-6 was seen at full width).  An MoE layer's output is
O(10–1000) (the reference draws expert weights at 1/sqrt(E)), so it is held
to 1e-5 relative to its largest value; the expert ids must be equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.arctic_480b import CONFIG as JAX_ARCTIC  # noqa: E402
from repro.configs.orloj_gpt import CONFIG as JAX_ORLOJ_GPT  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
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
    """The two options that raised until the decode path was ported now
    match the reference: softcap (a cap of 2 bends O(1) scores) and the
    repeat_kv formulation (GQA 4:2)."""
    params = _np_tree(jl.init_attention(jax.random.PRNGKey(4), 32, 4, 2, 16))
    kw = {"softcap": 2.0} if option == "softcap" else {"repeat_kv": True}
    jx, tx = _x(np.random.default_rng(4), (2, 24, 32))
    want = jl.attention_apply({k: jnp.asarray(v) for k, v in params.items()}, jx * 2,
                              n_kv=2, rope_theta=1e4, **kw)
    got = tl.attention_apply(_t(params), tx * 2, n_kv=2, rope_theta=1e4, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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


@pytest.mark.parametrize("name,want", [("orloj_gpt", JAX_ORLOJ_GPT), ("arctic_480b", JAX_ARCTIC)])
def test_config_copy_matches_the_reference(name, want):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(want)


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


@pytest.mark.parametrize("arch_change", [{"frontend": "vision", "n_frontend_tokens": 8},
                                         {"block_pattern": "hymba", "ssm_state": 16},
                                         {"block_pattern": "xlstm"}])
def test_blocks_not_ported_raise(arch_change):
    """The frontend and the block kinds that raised until they were ported
    now build and run a forward (their parity with the reference is held in
    test_torch_zoo.py and test_torch_ssm.py)."""
    cfg = dataclasses.replace(get_config("orloj_gpt").reduced(), **arch_change)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.ones((1, 8), dtype=torch.long)}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.ones((1, cfg.n_frontend_tokens, model.frontend_dim))
    with torch.no_grad():
        logits = model.logits(params, batch)
    assert logits.shape == (1, 8 + cfg.n_frontend_tokens, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------------------- MoE
def _moe_pair(d=64, ff=96, e=8, seed=10):
    params = _np_tree(jm.init_moe(jax.random.PRNGKey(seed), d, ff, e))
    return {k: jnp.asarray(v) for k, v in params.items()}, _t(params)


def _close_rel(got: torch.Tensor, want, rel: float = 1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (2, 0.25), (1, 1.0), (4, 2.0)])
def test_moe_apply_matches_jax(top_k, cf):
    """y and aux against the reference; capacity factor 0.25 forces drops
    into the dump row."""
    jp, tp = _moe_pair()
    rng = np.random.default_rng(11)
    jx, tx = _x(rng, (2, 24, 64))
    t = 48
    cap = tm.capacity(t, top_k, 8, cf)
    assert cap == jm.capacity(t, top_k, 8, cf)
    want_y, want_aux = jm.moe_apply(jp, jx, top_k=top_k, capacity_factor=cf)
    y, aux = tm.moe_apply(tp, tx, top_k=top_k, capacity_factor=cf)
    assert y.shape == (2, 24, 64) and y.dtype == torch.float32
    _close_rel(y, want_y)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    _, ids = ops.moe_gating(tx.reshape(t, 64) @ tp["router"], top_k)
    per_expert = np.bincount(ids.reshape(-1).numpy(), minlength=8)
    if cf == 0.25:
        assert cap == 8 and per_expert.max() > cap  # some assignments are dropped
        dense = tm.moe_ref(tp, tx, top_k=top_k)
        assert (y - dense).abs().max() > 1e-3  # ... and the drops show


def test_moe_capacity_rounds_like_the_reference():
    for t, k, e, cf in [(1, 1, 128, 1.25), (2048, 2, 128, 1.25), (48, 2, 8, 0.25), (100, 3, 7, 1.1)]:
        assert tm.capacity(t, k, e, cf) == jm.capacity(t, k, e, cf)
        assert tm.capacity(t, k, e, cf) % 8 == 0 and tm.capacity(t, k, e, cf) >= 8


def test_moe_apply_matches_its_dense_oracle_without_drops():
    jp, tp = _moe_pair(seed=12)
    rng = np.random.default_rng(12)
    _, tx = _x(rng, (3, 16, 64))
    y, _ = tm.moe_apply(tp, tx, top_k=2, capacity_factor=8.0)  # capacity ≥ every assignment
    _close_rel(y, tm.moe_ref(tp, tx, top_k=2).numpy())
    np.testing.assert_allclose(
        tm.moe_ref(tp, tx, top_k=2).numpy(), np.asarray(jm.moe_ref(jp, jnp.asarray(tx.numpy()), top_k=2)),
        rtol=1e-5, atol=1e-5 * float(tm.moe_ref(tp, tx, top_k=2).abs().max()),
    )


def test_moe_routes_through_the_gating_wrapper(monkeypatch):
    """moe_apply takes its top-k from ops.moe_gating (the kernel on a card)."""
    _, tp = _moe_pair(seed=13)
    calls = []
    real = ops.moe_gating

    def spy(logits, top_k):
        calls.append((tuple(logits.shape), top_k))
        return real(logits, top_k)

    monkeypatch.setattr(ops, "moe_gating", spy)
    tm.moe_apply(tp, torch.zeros((1, 5, 64)), top_k=2)
    assert calls == [((5, 8), 2)]


def test_moe_block_with_dense_residual_matches_jax():
    """Arctic's block: attention, then the MoE and the dense SwiGLU beside
    it on the same normed input, both added to the residual."""
    cfg = JAX_ARCTIC.reduced()
    assert cfg.is_moe and cfg.moe_dense_residual and cfg.norm == "rmsnorm"
    jparams = jb.init_block(jax.random.PRNGKey(14), cfg, 0)
    tparams = _t(_np_tree(jparams))
    assert set(tparams) == {"norm1", "attn", "norm2", "moe", "mlp"}
    rng = np.random.default_rng(14)
    jx, tx = _x(rng, (2, 16, cfg.d_model))
    want, want_aux = jb.block_apply(jparams, jx * 5, cfg, 0)
    got, aux = tb.block_apply(tparams, tx * 5, cfg, 0)
    _close_rel(got, want)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)


def test_model_logits_reduced_arctic():
    """The toy Arctic (2 layers, d 256, 4 experts top-2, dense residual,
    rmsnorm, f32, unscanned per-layer list)."""
    cfg = get_config("arctic_480b").reduced()
    assert not cfg.scan_layers and cfg.n_experts == 4 and cfg.top_k == 2
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, size=(2, 24))
    got, want = _logits_pair(cfg, tokens, seed=15)
    assert got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_model_logits_arctic_widths_scanned():
    """Arctic's attention at full width (d 7168, 56 query heads on 8 KV
    heads, head_dim 128), one scanned layer, with 8 experts, d_ff 512 and a
    512-word vocabulary so that it fits a test."""
    cfg = dataclasses.replace(get_config("arctic_480b"), n_layers=1, n_experts=8, d_ff=512, vocab_size=512)
    assert cfg.scan_layers and cfg.d_model == 7168 and cfg.resolved_head_dim == 128
    tokens = np.random.default_rng(16).integers(0, 512, size=(2, 16))
    got, want = _logits_pair(cfg, tokens, seed=16)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_convert_unstacks_scanned_expert_leaves():
    cfg = dataclasses.replace(get_config("arctic_480b").reduced(), n_layers=2, scan_layers=True)
    jparams = _np_tree(JaxModel(cfg).init(jax.random.PRNGKey(17)))
    stacked = jparams["blocks"][0]["moe"]
    assert stacked["w_gate"].shape == (2, 4, cfg.d_model, cfg.d_ff)
    params = from_numpy(jparams, cfg, device="cpu")
    for i, bp in enumerate(params["blocks"]):
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(bp["moe"][name].numpy(), stacked[name][i])
        assert bp["mlp"]["w_down"].shape == (cfg.d_ff, cfg.d_model)


def test_moe_init_draws_the_reference_shapes_and_scales():
    cfg = get_config("arctic_480b").reduced()
    jshapes = jax.tree.map(lambda a: a.shape, JaxModel(cfg).init(jax.random.PRNGKey(0)))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tshapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert tshapes == jax.tree.map(tuple, jshapes, is_leaf=lambda x: isinstance(x, tuple))
    w = params["blocks"][0]["moe"]["w_gate"]  # (E, d, f): 1/sqrt(E), the reference's shape[0] rule
    assert abs(w.std().item() - 1 / np.sqrt(cfg.n_experts)) < 0.05 / np.sqrt(cfg.n_experts)
