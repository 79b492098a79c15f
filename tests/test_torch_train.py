"""The port's training side against the JAX reference, on the CPU: the loss
and its gradients, recomputation, AdamW, the cosine schedule, the corpus,
train steps and the train CLI.

Weights come from the reference's ``Model.init`` and reach the port through
``convert.from_numpy``; batches come from numpy with a seed (or from the
corpus, which both packages share line for line).  Tolerances: the loss to
1e-5 relative and absolute (float32 sums in another order; at random
weights a loss can be ~250, where one float32 step is 1.5e-5); every gradient leaf to
rtol 1e-4 and atol 1e-4 of the leaf's largest |g| (a backward pass sums
the same products in more orders than the forward, as in
``test_torch_head_dims.py``); one AdamW update to 1e-6 (the same float32
arithmetic leaf by leaf; the gradient norm summed over the leaves in the
reference's order); three train steps' losses as the loss.
"""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import from_numpy, to_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
TRAIN_ARCHS = ["orloj_gpt", "arctic_480b", "dbrx_132b", "glm4_9b", "granite_34b", "olmo_1b",
               "nemotron_4_340b", "hymba_1_5b", "xlstm_1_3b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(cfg, seed):
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tparams = from_numpy(_np_tree(jparams), cfg, device="cpu")
    for p in tadamw.leaves(tparams):
        p.requires_grad_(True)
    return jm, jparams, Model(cfg, device="cpu"), tparams


def _batch(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s))
    labels = rng.integers(0, cfg.vocab_size, size=(b, s))
    labels[0, :3] = -1  # masked positions
    labels[1, -2:] = -1
    return tokens, labels


def _hold_loss_and_grads(cfg, seed, s=24):
    jm, jparams, tm, tparams = _pair(cfg, seed)
    tokens, labels = _batch(cfg, seed, s=s)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jparams, jbatch)
    want = _np_tree(jgrads)
    loss = tm.loss(tparams, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    _close(float(loss.detach()), float(jloss))
    flat = tadamw.leaves(tparams)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    got = to_numpy(_unflatten_like(tparams, [g.detach() for g in grads]), cfg)
    for (path, g), (_, w) in zip(_items(got), _items(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_RTOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=path)
    return len(flat)


def _close(got: float, want: float) -> None:
    assert abs(got - want) <= LOSS_TOL * (1 + abs(want)), (got, want)


def _unflatten_like(tree, flat: list):
    """``flat`` (in :func:`tadamw.leaves` order) in the structure of ``tree``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    out = build(tree)
    assert next(it, None) is None
    return out


def _items(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _items(v, f"{path}/{i}")
    else:
        yield path, tree


# ----------------------------------------------------------------- loss
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch):
    """``Model.loss`` and d loss/dθ for every leaf, against
    ``jax.value_and_grad(repro.models.Model.loss)`` on the same weights and
    batch (masked labels included); MoE archs take their aux loss too."""
    n = _hold_loss_and_grads(get_config(arch).reduced(), seed=50 + TRAIN_ARCHS.index(arch))
    assert n > 5


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_glm_remat_scanned_and_chunked_loss_match_jax(policy):
    """GLM-4 with recomputation, a scanned stack in the reference and a loss
    chunked along S (40 positions in chunks of 16: padded to 48), under both
    recomputation policies."""
    cfg = get_config("glm4_9b").reduced(remat=True, scan_layers=True, loss_chunk=16,
                                        remat_policy=policy)
    assert cfg.loss_chunk < 40
    _hold_loss_and_grads(cfg, seed=60, s=40)


def test_remat_reruns_the_blocks_in_the_backward(monkeypatch):
    """With ``remat`` each block's forward runs again in the backward."""
    from repro_torch.models import model as model_mod

    calls = []
    real = model_mod.block_apply

    def counting(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kw)

    monkeypatch.setattr(model_mod, "block_apply", counting)
    for remat, want in ((False, 2), (True, 4)):
        cfg = get_config("glm4_9b").reduced(remat=remat)
        tm = Model(cfg, device="cpu")
        params = tm.init(torch.Generator().manual_seed(0))
        for p in tadamw.leaves(params):
            p.requires_grad_(True)
        tokens, labels = _batch(cfg, 0, s=8)
        calls.clear()
        loss = tm.loss(params, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
        loss.backward()
        assert len(calls) == want, (remat, calls)


def test_loss_masks_every_label_gives_aux_alone():
    """All labels masked: the cross entropy is 0 / max(0, 1) and the loss is
    0.01 · aux, as in the reference."""
    cfg = get_config("dbrx_132b").reduced()
    jm, jparams, tm, tparams = _pair(cfg, 70)
    tokens, _ = _batch(cfg, 70)
    labels = -np.ones_like(tokens)
    want = jax.jit(jm.loss)(jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    with torch.no_grad():
        got = tm.loss(tparams, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    _close(float(got), float(want))
    assert float(got) > 0


# ---------------------------------------------------------------- AdamW
def _opt_tree(rng, scale):
    shapes = {"embed": {"table": (6, 4)}, "blocks": [{"w": (4, 3), "norm": {"scale": (4,)}},
                                                      {"w": (4, 3), "norm": {"scale": (4,)}}],
              "lm_head": (4, 6)}
    return jax.tree.map(lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("case", ["clipped", "unclipped", "later step"])
def test_adamw_update_matches_the_reference(case):
    rng = np.random.default_rng({"clipped": 80, "unclipped": 81, "later step": 82}[case])
    params = _opt_tree(rng, 1.0)
    grads = _opt_tree(rng, 3.0 if case == "clipped" else 0.01)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20)
    jstate = jadamw.adamw_init(params)
    if case == "later step":
        jstate = {"m": _opt_tree(rng, 0.1), "v": jax.tree.map(np.abs, _opt_tree(rng, 0.1)),
                  "step": jnp.int32(5)}
    norm = float(np.sqrt(sum(np.sum(np.square(g)) for g in jax.tree.leaves(grads))))
    assert (norm > 1.0) == (case == "clipped")
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    tgrads = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), grads)
    tstate = {"m": jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jstate["m"]),
              "v": jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jstate["v"]),
              "step": torch.tensor(int(jstate["step"]), dtype=torch.int32)}
    if case != "later step":
        tstate = tadamw.adamw_init(tparams)
    jp, js = jadamw.adamw_update(jadamw.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, grads), jstate)
    tp, ts = tadamw.adamw_update(tadamw.AdamWConfig(**cfg), tparams, tgrads, tstate)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"])
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for (path, g), (_, w) in zip(_items(jax.tree.map(lambda t: t.numpy(), got)),
                                     _items(_np_tree(want)), strict=True):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f"{case} {path}")


def test_adamw_init_is_zeros_and_step_int32():
    params = {"a": torch.ones(3), "b": [torch.ones(2, 2)]}
    st = tadamw.adamw_init(params)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert all(float(t.abs().sum()) == 0 for t in tadamw.leaves(st["m"]) + tadamw.leaves(st["v"]))


@pytest.mark.parametrize("step", [0, 10, 55, 100, 140])
def test_cosine_schedule_matches_the_reference(step):
    """At step 0, the end of warm-up, mid-decay, the last step and past it."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    want = float(jadamw.cosine_schedule(jadamw.AdamWConfig(**kw), jnp.int32(step)))
    got = tadamw.cosine_schedule(tadamw.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * 3e-4, (float(got), want)


# ----------------------------------------------------------------- data
def test_corpus_is_the_references_line_for_line():
    for name in ("DataConfig", "SyntheticCorpus"):
        assert inspect.getsource(getattr(tpipe, name)) == inspect.getsource(getattr(jpipe, name)), name


def test_first_three_batches_equal_the_references():
    cfg_kw = dict(vocab_size=1000, seq_len=32, batch_size=3, seed=7)
    want = jpipe.make_train_iterator(jpipe.DataConfig(**cfg_kw))
    got = tpipe.make_train_iterator(tpipe.DataConfig(**cfg_kw), "cpu")
    for _ in range(3):
        w, g = next(want), next(got)
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int64 and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_train_iterator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is taken, not refused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tpipe.make_train_iterator(tpipe.DataConfig(vocab_size=10, seq_len=4, batch_size=1)))


# ---------------------------------------------------------- train steps
def test_three_train_steps_match_the_reference():
    """The same weights and corpus batches through three steps of each
    package's loss, gradient and AdamW update: the losses agree."""
    cfg = get_config("olmo_1b").reduced()
    jm, jparams, tm, tparams = _pair(cfg, 90)
    opt = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jopt, topt = jadamw.AdamWConfig(**opt), tadamw.AdamWConfig(**opt)

    @jax.jit
    def jstep(params, state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        params, state = jadamw.adamw_update(jopt, params, grads, state)
        return params, state, loss

    tstep = ttrain.make_train_step(tm, topt)
    jstate, tstate = jadamw.adamw_init(jparams), tadamw.adamw_init(tparams)
    data = jpipe.SyntheticCorpus(jpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=24, batch_size=2))
    jl, tl = [], []
    for _ in range(3):
        b = data.batch()
        jparams, jstate, jloss = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tparams, tstate, tloss = tstep(tparams, tstate, {k: torch.from_numpy(v.astype(np.int64))
                                                         for k, v in b.items()})
        jl.append(float(jloss))
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert tl[-1] != tl[0]


def test_train_cli_on_the_cpu_resumes_from_its_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16", "--log-every", "2", "--ckpt-dir", ck]
    losses = ttrain.main(["--steps", "4", *argv])
    out = capsys.readouterr().out
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert out.splitlines()[0].startswith("arch=orloj-gpt-smoke params≈") and "device=cpu" in out
    assert "step     2 loss " in out and "ms/step" in out
    assert ("(improved)" in out) or ("(NOT improved)" in out)
    assert (tmp_path / "ck" / "step_00000004.npz").exists()
    more = ttrain.main(["--steps", "6", *argv])
    out = capsys.readouterr().out
    assert "restored step 4" in out and len(more) == 2
    assert (tmp_path / "ck" / "step_00000006.npz").exists()


def test_train_cli_refuses_frontends_and_defaults_to_the_card():
    with pytest.raises(SystemExit, match="needs frontend embeddings"):
        ttrain.main(["--arch", "internvl2_1b", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--steps", "1"])


def test_train_returns_losses_and_records_the_run():
    rec = {}
    cfg = dataclasses.replace(get_config("orloj_gpt").reduced(), n_layers=1)
    losses = ttrain.train(cfg, steps=3, batch=2, seq=8, log_every=1, device="cpu", record=rec)
    assert len(losses) == 3 and len(rec["step_ms"]) == 3 and len(rec["data_ms"]) == 3
    assert all(0 <= d <= s for d, s in zip(rec["data_ms"], rec["step_ms"]))
    assert int(rec["opt_state"]["step"]) == 3
