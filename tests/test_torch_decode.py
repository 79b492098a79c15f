"""The port's decode path against the JAX reference, on the CPU.

``attention_decode``, ``block_decode`` and ``Model.decode_step`` of
``repro_torch.models`` are held against ``repro.models`` step by step, on
the same weights (drawn by the reference's ``init`` and converted) and the
same inputs (numpy, seeded): the outputs and the caches after every step.

Tolerances: 1e-5 for one layer's output and a float32 cache (the frameworks
sum matrix products in another order; values are O(1)); 2e-5 for a model's
logits (the same rounding over the layers and the d-wide head, as in
``test_torch_models.py``); a bfloat16 cache to one bf16 step (2**-7
relative: a value within a rounding of a bf16 boundary may round the other
way after a 1e-7 difference upstream), and the outputs read from it to
1e-4.  The port's decode ≡ forward, on the port alone, to 2e-5, far tighter
than the 5e-2 of the reference's own test (``test_arch_smoke.py``).  An
MoE's outputs are O(10–1000) and are held relative to their largest value.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import Model as JaxModel  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.convert import cache_from_numpy, cache_to_numpy, from_numpy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_CACHE_TOL = dict(rtol=2**-7, atol=1e-6)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close_cache(got: torch.Tensor, want, dtype: str):
    """A port cache leaf (B, KV, S, hd) against the reference's (B, S, KV, hd)."""
    assert got.dtype == DTYPES[dtype][1]
    want = np.asarray(want.astype(jnp.float32))
    tol = BF16_CACHE_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(got.float().transpose(1, 2).numpy(), want, **tol)


# ------------------------------------------------------- attention_decode
@pytest.mark.parametrize(
    "name,h,kv,window,cache_len,positions,dtype,softcap,pos_kind",
    [
        ("MHA", 4, 4, 0, 16, range(6), "float32", 0.0, "int"),
        ("GQA", 4, 2, 0, 16, range(6), "float32", 0.0, "int"),
        ("MQA", 4, 1, 0, 16, range(6), "float32", 0.0, "int"),
        ("window ring wraps", 4, 2, 8, 8, range(20), "float32", 0.0, "int"),
        ("window ring wraps, pos a tensor", 4, 2, 8, 8, range(20), "float32", 0.0, "tensor"),
        ("pos past the cache: clamped write", 4, 2, 0, 8, range(5, 12), "float32", 0.0, "int"),
        ("clamped write, pos a tensor", 4, 2, 0, 8, range(5, 12), "float32", 0.0, "tensor"),
        ("clamped write, pos an int32 tensor", 4, 2, 0, 8, range(5, 12), "float32", 0.0, "int32"),
        ("window ring wraps, pos an int32 tensor", 4, 2, 8, 8, range(20), "float32", 0.0, "int32"),
        ("bf16 cache", 4, 2, 0, 16, range(6), "bfloat16", 0.0, "int"),
        ("bf16 cache, ring wraps", 4, 1, 6, 6, range(14), "bfloat16", 0.0, "tensor"),
        ("softcap", 4, 2, 0, 16, range(6), "float32", 2.0, "int"),
    ],
)
def test_attention_decode_matches_jax(name, h, kv, window, cache_len, positions, dtype, softcap,
                                      pos_kind):
    """Step by step from a cache of random contents: each step's output and
    the whole cache after it."""
    d, hd, b = 64, 32, 3
    jdt, tdt = DTYPES[dtype]
    params = _np_tree(jl.init_attention(jax.random.PRNGKey(20), d, h, kv, hd))
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _t(params)
    rng = np.random.default_rng(20)
    start = {n: rng.normal(size=(b, cache_len, kv, hd)).astype(np.float32) for n in ("k", "v")}
    jcache = {n: jnp.asarray(a).astype(jdt) for n, a in start.items()}
    tcache = {n: torch.from_numpy(a).transpose(1, 2).contiguous().to(tdt) for n, a in start.items()}
    kw = dict(n_kv=kv, rope_theta=10_000.0, sliding_window=window, softcap=softcap)
    for pos in positions:
        jx, tx = _x(rng, (b, 1, d))
        want, jcache = jl.attention_decode(jp, jx, jcache, jnp.int32(pos), **kw)
        tpos = {"int": pos, "tensor": torch.tensor(pos),
                "int32": torch.tensor(pos, dtype=torch.int32)}[pos_kind]
        got, tcache = tl.attention_decode(tp, tx, tcache, tpos, **kw)
        assert got.shape == (b, 1, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **(dict(rtol=1e-4, atol=1e-4) if dtype == "bfloat16" else TOL))
        for n in ("k", "v"):
            _close_cache(tcache[n], jcache[n], dtype)


def test_attention_decode_updates_the_cache_in_place():
    params = _t(_np_tree(jl.init_attention(jax.random.PRNGKey(21), 32, 2, 2, 16)))
    cache = tl.init_kv_cache(1, 2, 4, 16, torch.float32, device="cpu")
    k_before = cache["k"]
    _, out_cache = tl.attention_decode(params, torch.ones((1, 1, 32)), cache, 0, n_kv=2,
                                       rope_theta=1e4)
    assert out_cache["k"] is k_before and bool((k_before[:, :, 0] != 0).any())
    assert bool((k_before[:, :, 1:] == 0).all())


def test_plain_decode_attention_reads_a_bf16_cache_as_float32():
    """The plain version under float32 queries over a bf16 cache is the
    float32 computation over the cache's values; the kernel's checks take
    that pair and refuse bf16 queries over a float32 cache."""
    rng = np.random.default_rng(22)
    q = torch.from_numpy(rng.normal(size=(2, 8, 64)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.normal(size=(2, 2, 40, 64)).astype(np.float32)).bfloat16()
              for _ in range(2))
    vl = torch.tensor([40, 17], dtype=torch.int32)
    got = ref.decode_attention_ref(q, kc, vc, vl)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref.decode_attention_ref(q, kc.float(), vc.float(), vl),
                               rtol=0, atol=0)
    dec_mod.check_inputs(q, kc, vc, vl)
    with pytest.raises(TypeError, match="types"):
        dec_mod.check_inputs(q.bfloat16(), kc.float(), vc.float(), vl)
    with pytest.raises(ValueError, match="softcap"):
        dec_mod.check_inputs(q, kc, vc, vl, softcap=-1.0)


# ----------------------------------------------------------- block_decode
@pytest.mark.parametrize("arch", ["glm4_9b", "dbrx_132b", "arctic_480b"])
def test_block_decode_matches_jax(arch):
    """Dense (GLM-4: rmsnorm, SwiGLU, GQA), MoE (DBRX: layernorm, top-2 of
    4) and Arctic's dense residual beside the MoE, five steps each."""
    cfg = get_config(arch).reduced()
    jparams = jb.init_block(jax.random.PRNGKey(23), cfg, 0)
    tparams = _t(_np_tree(jparams))
    jcache = jb.init_block_cache(cfg, 0, 2, 8, jnp.float32)
    tcache = tb.init_block_cache(cfg, 0, 2, 8, torch.float32, device="cpu")
    assert tcache["kv"]["k"].shape == (2, cfg.n_kv_heads, 8, cfg.resolved_head_dim)
    rng = np.random.default_rng(23)
    for pos in range(5):
        jx, tx = _x(rng, (2, 1, cfg.d_model))
        want, jcache = jb.block_decode(jparams, jx * 3, jcache, jnp.int32(pos), cfg, 0)
        got, tcache = tb.block_decode(tparams, tx * 3, tcache, pos, cfg, 0)
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
        for n in ("k", "v"):
            _close_cache(tcache["kv"][n], jcache["kv"][n], "float32")


def test_block_cache_is_a_ring_of_the_window():
    cfg = get_config("glm4_9b").reduced(sliding_window=16)
    assert tb.init_block_cache(cfg, 0, 2, 64, torch.float32, "cpu")["kv"]["k"].shape[2] == 16
    assert tb.init_block_cache(cfg, 0, 2, 8, torch.float32, "cpu")["kv"]["k"].shape[2] == 8


def test_caches_default_to_the_card():
    """Like every entry point of the port, the cache allocators take the
    CPU only on request: without a card, the default raises."""
    cfg = get_config("glm4_9b").reduced()
    for make in (lambda: tl.init_kv_cache(1, 2, 4, 16),
                 lambda: tb.init_block_cache(cfg, 0, 1, 4)):
        if torch.cuda.is_available():
            cache = make()
            assert cache.get("kv", cache)["k"].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


# ------------------------------------------------------ Model.decode_step
def _step_inputs(cfg, rng, batch: int, steps: int) -> np.ndarray:
    """What decode_step takes for ``steps`` positions: token ids, or for an
    audio model its (B, steps, 512) frame embeddings."""
    if cfg.frontend == "audio":
        return rng.normal(size=(batch, steps, 512)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, size=(batch, steps))


def _forward_batch(cfg, inputs: torch.Tensor) -> dict:
    """The forward's batch for the same positions: an audio model reads the
    frame embeddings; a vision model takes an empty image prefix, since the
    decode step reads tokens only."""
    if cfg.frontend == "audio":
        return {"frontend_embeds": inputs}
    if cfg.frontend == "vision":
        return {"frontend_embeds": torch.zeros((inputs.shape[0], 0, 1024)), "tokens": inputs}
    return {"tokens": inputs}


def _decode_pair(cfg, seed: int, steps: int, dtype: str, batch: int = 2, cache_len: int = 16):
    """The reference's and the port's decode_step over ``steps`` tokens on
    the same weights; yields (step, port logits, reference logits, port
    cache, reference cache) after every step."""
    jdt, tdt = DTYPES[dtype]
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = Model(cfg, device="cpu")
    tparams = from_numpy(_np_tree(jparams), cfg, device="cpu")
    jcache = jm.init_cache(batch, cache_len=cache_len, dtype=jdt)
    tcache = tm.init_cache(batch, cache_len, dtype=tdt)
    tokens = _step_inputs(cfg, np.random.default_rng(seed), batch, steps)
    for i in range(steps):
        want, jcache = jm.decode_step(jparams, jnp.asarray(tokens[:, i : i + 1]), jcache,
                                      jnp.int32(i))
        with torch.no_grad():
            got, tcache = tm.decode_step(tparams, torch.from_numpy(tokens[:, i : i + 1]), tcache, i)
        yield i, got, np.asarray(want), tcache, jcache


def _close_caches(tcache, jcache, cfg, dtype: str):
    got = cache_to_numpy(tcache, cfg)
    want = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jcache)
    tol = BF16_CACHE_TOL if dtype == "bfloat16" else TOL
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize(
    "arch,dtype",
    [(a, "float32") for a in ARCHS] + [("glm4_9b", "bfloat16"), ("dbrx_132b", "bfloat16")],
)
def test_decode_step_matches_jax(arch, dtype):
    """Eight steps of every arch of the port at ``.reduced()`` (MusicGen
    on frame embeddings): the logits after each step and the whole cache
    after the last."""
    cfg = get_config(arch).reduced()
    for i, got, want, tcache, jcache in _decode_pair(cfg, seed=24, steps=8, dtype=dtype):
        assert got.shape == (2, 1, cfg.vocab_size) and got.dtype == torch.float32
        scale = max(1.0, float(np.abs(want).max())) if cfg.is_moe else 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5 if dtype == "float32" else 1e-4,
                                   atol=(2e-5 if dtype == "float32" else 1e-4) * scale)
    _close_caches(tcache, jcache, cfg, dtype)


def test_repeat_kv_and_softcap_model_matches_jax():
    """GLM-4 reduced with the reference's repeat_kv formulation and a logit
    softcap: the forward and the decode steps."""
    cfg = get_config("glm4_9b").reduced(gqa_repeat_kv=True, logit_softcap=2.0)
    tokens = np.random.default_rng(25).integers(0, cfg.vocab_size, size=(2, 12))
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(25))
    tparams = from_numpy(_np_tree(jparams), cfg, device="cpu")
    with torch.no_grad():
        got = Model(cfg, device="cpu").logits(tparams, {"tokens": torch.from_numpy(tokens)})
    want = np.asarray(jm.logits(jparams, {"tokens": jnp.asarray(tokens)}))
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)
    for _, got, want, _, _ in _decode_pair(cfg, seed=25, steps=6, dtype="float32"):
        np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


@pytest.mark.parametrize("arch", [a for a in ARCHS if not get_config(a).is_moe])
def test_decode_matches_forward(arch):
    """Token by token through decode_step gives the forward's logits."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(26))
    tokens = torch.from_numpy(_step_inputs(cfg, np.random.default_rng(26), 2, 10))
    with torch.no_grad():
        full = model.logits(params, _forward_batch(cfg, tokens))
        cache = model.init_cache(2, 16, dtype=torch.float32)
        steps = []
        for i in range(tokens.shape[1]):
            lg, cache = model.decode_step(params, tokens[:, i : i + 1], cache, i)
            steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), **LOGITS_TOL)


def test_decode_step_makes_the_slot_once_per_step(monkeypatch):
    """The slot, the valid length and the rotary tables are the same for
    every layer: a step of a 3-layer model makes them once."""
    from repro_torch.models import model as model_mod

    cfg = dataclasses.replace(get_config("glm4_9b").reduced(), n_layers=3)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(30))
    made = []

    def counting(*args, **kw):
        made.append(args[0])
        return tl.decode_slot(*args, **kw)

    monkeypatch.setattr(model_mod, "decode_slot", counting)
    cache = model.init_cache(2, 8, dtype=torch.float32)
    with torch.no_grad():
        for i in range(2):
            model.decode_step(params, torch.ones((2, 1), dtype=torch.long), cache, i)
    assert made == [0, 1]


def test_prefill_returns_the_last_logits_and_no_cache():
    cfg = get_config("olmo_1b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(27))
    tokens = torch.from_numpy(np.random.default_rng(27).integers(0, cfg.vocab_size, size=(2, 9)))
    with torch.no_grad():
        last, cache = model.prefill(params, {"tokens": tokens}, cache_len=16)
        full = model.logits(params, {"tokens": tokens})
    assert cache is None and last.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(), **LOGITS_TOL)  # another GEMM shape


def test_decode_step_at_glm4_widths_scanned():
    """GLM-4-9B's widths (d 4096, 32 query heads on 2 KV heads of 128, d_ff
    13696) at one scanned layer with a 512-word vocabulary: logits and the
    bf16 cache (the reference's default) of four steps, converted back to
    the reference's stacked layout."""
    cfg = dataclasses.replace(get_config("glm4_9b"), n_layers=1, vocab_size=512)
    assert cfg.scan_layers and cfg.d_model == 4096 and cfg.resolved_head_dim == 128
    for _, got, want, tcache, jcache in _decode_pair(cfg, seed=28, steps=4, dtype="bfloat16",
                                                     cache_len=8):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert len(jcache) == 1 and jcache[0]["kv"]["k"].shape == (1, 2, 8, 2, 128)
    _close_caches(tcache, jcache, cfg, "bfloat16")


def test_cache_conversion_round_trips_the_scanned_layout():
    cfg = dataclasses.replace(get_config("glm4_9b").reduced(), n_layers=3, scan_layers=True)
    jcache = JaxModel(cfg).init_cache(2, cache_len=8, dtype=jnp.bfloat16)
    rng = np.random.default_rng(29)
    jcache = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.bfloat16), jcache)
    tcache = cache_from_numpy(_np_tree(jcache), cfg, device="cpu")
    assert len(tcache) == 3 and tcache[1]["kv"]["v"].shape == (2, cfg.n_kv_heads, 8, 64)
    assert tcache[1]["kv"]["v"].dtype == torch.bfloat16
    back = cache_to_numpy(tcache, cfg)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jcache), strict=True):
        np.testing.assert_array_equal(g, np.asarray(w.astype(jnp.float32)))
    with pytest.raises(ValueError, match="one unit"):
        cache_from_numpy(_np_tree(jcache) * 2, cfg, device="cpu")
