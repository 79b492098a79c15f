"""Head sizes 16 and 192, and gradients through the plain route, against the
JAX reference on the CPU.

Head size 16 is the engine-smoke toy's (``ENGINE_MODELS["orloj_gpt"]``:
d_model 64 over 4 heads); 192 is Nemotron-4-340B's.  ``.reduced()`` gives
Nemotron head size 64, so its cases ask for ``.reduced(head_dim=192)``.
The layers, the model's logits and its decode steps are held against the
reference on the same weights (drawn by the reference and converted), with
the tolerances of ``test_torch_models.py`` and ``test_torch_decode.py``:
1e-5 for one layer, 2e-5 for a model's logits.

On the CPU the kernels' plain versions are plain torch ops that autograd
follows (on the card, flash attention, RMSNorm and the gates go through
their backward kernels; ``tests/test_torch_cuda.py``).  The gradient of a scalar of the logits with respect to
every parameter is held against ``jax.grad`` of the reference's, to 1e-4
relative to each leaf's largest gradient (a backward pass sums the same
products in more orders than the forward).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.eval.substrate import ENGINE_MODELS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.convert import from_numpy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)


def _toy():
    """The engine-smoke grid's model: orloj_gpt.reduced() at d 64 over 4 heads."""
    return get_config("orloj_gpt").reduced(**dict(ENGINE_MODELS["orloj_gpt"].config_overrides))


def _nemotron():
    return get_config("nemotron_4_340b").reduced(head_dim=192)


CONFIGS = {"toy hd 16": _toy, "nemotron hd 192": _nemotron}


def test_the_configs_have_the_head_sizes():
    assert _toy().resolved_head_dim == 16 and _toy().d_model == 64
    cfg = _nemotron()
    assert cfg.resolved_head_dim == 192 and cfg.n_heads == 4 and cfg.n_kv_heads == 2


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _x(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("hd,n_heads,n_kv,window", [(16, 4, 4, 0), (16, 4, 2, 8), (192, 4, 2, 0),
                                                     (192, 4, 1, 16)])
def test_attention_apply_matches_jax(hd, n_heads, n_kv, window):
    d, s = 64, 40
    params = _np_tree(jl.init_attention(jax.random.PRNGKey(40), d, n_heads, n_kv, hd))
    jx, tx = _x(np.random.default_rng(40), (2, s, d))
    want = jl.attention_apply({k: jnp.asarray(v) for k, v in params.items()}, jx,
                              n_kv=n_kv, rope_theta=10_000.0, sliding_window=window)
    got = tl.attention_apply(_t(params), tx, n_kv=n_kv, rope_theta=10_000.0, sliding_window=window)
    assert got.shape == (2, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hd,n_kv,dtype", [(16, 4, "float32"), (16, 2, "bfloat16"), (192, 2, "float32"),
                                           (192, 1, "bfloat16")])
def test_attention_decode_matches_jax(hd, n_kv, dtype):
    """Six steps from a cache of random contents: outputs and the cache."""
    d, h, b, cache_len = 64, 4, 3, 16
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params = _np_tree(jl.init_attention(jax.random.PRNGKey(41), d, h, n_kv, hd))
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _t(params)
    rng = np.random.default_rng(41)
    start = {n: rng.normal(size=(b, cache_len, n_kv, hd)).astype(np.float32) for n in ("k", "v")}
    jcache = {n: jnp.asarray(a).astype(jdt) for n, a in start.items()}
    tcache = {n: torch.from_numpy(a).transpose(1, 2).contiguous().to(tdt) for n, a in start.items()}
    kw = dict(n_kv=n_kv, rope_theta=10_000.0, sliding_window=0, softcap=0.0)
    for pos in range(6):
        jx, tx = _x(rng, (b, 1, d))
        want, jcache = jl.attention_decode(jp, jx, jcache, jnp.int32(pos), **kw)
        got, tcache = tl.attention_decode(tp, tx, tcache, pos, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **(dict(rtol=1e-4, atol=1e-4) if dtype == "bfloat16" else TOL))
    for n in ("k", "v"):
        want = np.asarray(jcache[n].astype(jnp.float32))
        np.testing.assert_allclose(tcache[n].float().transpose(1, 2).numpy(), want,
                                   **(dict(rtol=2**-7, atol=1e-6) if dtype == "bfloat16" else TOL))


def _pair(cfg, seed):
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    return jm, jparams, Model(cfg, device="cpu"), from_numpy(_np_tree(jparams), cfg, device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_logits_match_jax(name):
    cfg = CONFIGS[name]()
    jm, jparams, tm, tparams = _pair(cfg, seed=42)
    tokens = np.random.default_rng(42).integers(0, cfg.vocab_size, size=(2, 24))
    want = np.asarray(jm.logits(jparams, {"tokens": jnp.asarray(tokens)}))
    with torch.no_grad():
        got = tm.logits(tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_step_matches_jax(name):
    """Eight decode steps with a float32 cache: logits after every step."""
    cfg = CONFIGS[name]()
    jm, jparams, tm, tparams = _pair(cfg, seed=43)
    jcache = jm.init_cache(2, cache_len=16, dtype=jnp.float32)
    tcache = tm.init_cache(2, 16, dtype=torch.float32)
    tokens = np.random.default_rng(43).integers(0, cfg.vocab_size, size=(2, 8))
    for i in range(8):
        want, jcache = jm.decode_step(jparams, jnp.asarray(tokens[:, i : i + 1]), jcache, jnp.int32(i))
        with torch.no_grad():
            got, tcache = tm.decode_step(tparams, torch.from_numpy(tokens[:, i : i + 1]), tcache, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)


# ------------------------------------------------------------- gradients
@pytest.mark.parametrize("arch", ["orloj_gpt", "glm4_9b", "arctic_480b"])
def test_plain_route_gradients_match_jax_grad(arch):
    """d/dθ of Σ logits·w on the CPU port, against ``jax.grad`` of the
    reference on the same weights, tokens and w: every leaf, ``wq`` of each
    layer among them.  An MoE's routing ids take no gradient in either
    framework; the gates do."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    jm, jparams, tm, tparams = _pair(cfg, seed=44)
    rng = np.random.default_rng(44)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 12))
    w = rng.normal(size=(2, 12, cfg.vocab_size)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.logits(p, {"tokens": jnp.asarray(tokens)}) * jnp.asarray(w))

    jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(jparams))
    jgrads = from_numpy(jgrads, cfg, device="cpu")
    leaves = []

    def walk(tree, want, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], want[k], f"{path}/{k}")
        elif isinstance(tree, list):
            for i, (a, b) in enumerate(zip(tree, want, strict=True)):
                walk(a, b, f"{path}/{i}")
        else:
            tree.requires_grad_(True)
            leaves.append((path, tree, want))

    walk(tparams, jgrads, "")
    loss = (tm.logits(tparams, {"tokens": torch.from_numpy(tokens)}) * torch.from_numpy(w)).sum()
    loss.backward()
    wq = [p for p, _, _ in leaves if p.endswith("/attn/wq")]
    assert len(wq) == cfg.n_layers
    for path, leaf, want in leaves:
        assert leaf.grad is not None, path
        scale = max(float(want.abs().max()), 1e-6)
        np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=path)


def test_plain_route_launches_no_kernel_and_keeps_the_graph():
    """What the card refuses, the CPU route takes: the four ops on CPU
    tensors that require grad return outputs with a graph."""
    g = torch.Generator().manual_seed(45)
    q = torch.randn((1, 2, 8, 16), generator=g, requires_grad=True)
    outs = [
        ops.flash_attention(q, q, q),
        ops.decode_attention(q[:, :, 0], q, q, torch.tensor([8], dtype=torch.int32)),
        ops.rmsnorm(q, torch.ones(16)),
        ops.moe_gating(q.reshape(-1, 16), 2)[0],
    ]
    before = ops.launch_counts()
    assert all(o.requires_grad and o.grad_fn is not None for o in outs)
    sum(o.sum() for o in outs).backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert ops.launch_counts() == before
