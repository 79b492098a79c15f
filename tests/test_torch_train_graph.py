"""The training step as one program, and the corpus's unigram draws, on the
CPU.

On a CUDA device ``launch.train.TrainProgram`` runs its first step eagerly
and replays a captured CUDA graph of the same step after it; on the CPU
every call runs that body eagerly over the program's static batch
buffers.  These tests hold what the graph relies on where a CPU can show
it: the body over the static buffers equals ``make_train_step`` bit for
bit (losses, parameters, moments, ``step``) and the reference's jitted
step within ``LOSS_TOL`` (1e-5, as ``tests/test_torch_train.py``); the
program refuses trees it was not built with; AdamW advances ``step`` in
the same tensor.  ``CdfCorpus`` gives ``SyntheticCorpus``'s token stream
exactly, and leaves its generator where ``SyntheticCorpus`` leaves it.
The replays are held on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

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
from repro_torch.models.convert import from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

LOSS_TOL = 1e-5
CONFIGS = {
    "orloj_gpt": lambda: get_config("orloj_gpt").reduced(),
    "glm4_9b remat": lambda: get_config("glm4_9b").reduced(remat=True),
    "glm4_9b remat dots, chunked loss": lambda: get_config("glm4_9b").reduced(
        remat=True, remat_policy="dots", loss_chunk=8),
}


def _state(model, seed):
    params = model.init(torch.Generator().manual_seed(seed))
    for p in tadamw.leaves(params):
        p.requires_grad_(True)
    return params, tadamw.adamw_init(params)


def _batches(cfg, n, b=2, s=20, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, cfg.vocab_size, size=(b, s))
        labels = rng.integers(0, cfg.vocab_size, size=(b, s))
        labels[0, :3] = -1
        out.append({"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    return out


def _opt(steps=3):
    return tadamw.AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=1)


# ------------------------------------------------------------ the program
@pytest.mark.parametrize("name", list(CONFIGS))
def test_program_body_equals_make_train_step_bit_for_bit(name):
    """Three steps of the program (its body over the static buffers) and of
    ``make_train_step`` from the same weights and batches: every loss,
    parameter, moment and ``step`` equal bit for bit."""
    cfg = CONFIGS[name]()
    model = Model(cfg, device="cpu")
    (p1, s1), (p2, s2) = _state(model, 7), _state(model, 7)
    program = ttrain.TrainProgram(model, _opt(), p1, s1, (2, 20))
    eager = ttrain.make_train_step(model, _opt())
    losses = []
    for batch in _batches(cfg, 3):
        p1, s1, l1 = program(p1, s1, batch)
        p2, s2, l2 = eager(p2, s2, batch)
        assert torch.equal(l1, l2), (float(l1), float(l2))
        losses.append(float(l1))
    assert program.graph is None and p1 is program.params and s1 is program.opt_state
    assert int(s1["step"]) == int(s2["step"]) == 3 and len(set(losses)) == 3
    for tree1, tree2 in ((p1, p2), (s1["m"], s2["m"]), (s1["v"], s2["v"])):
        for a, b in zip(tadamw.leaves(tree1), tadamw.leaves(tree2), strict=True):
            assert torch.equal(a, b)


def test_three_program_steps_match_the_reference():
    """The same weights and corpus batches through three steps of the
    program and of the reference's jitted loss, gradient and AdamW update:
    the losses agree within LOSS_TOL."""
    cfg = get_config("olmo_1b").reduced()
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(91))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    for p in tadamw.leaves(tparams):
        p.requires_grad_(True)
    opt = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jopt = jadamw.AdamWConfig(**opt)

    @jax.jit
    def jstep(params, state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        params, state = jadamw.adamw_update(jopt, params, grads, state)
        return params, state, loss

    jstate, tstate = jadamw.adamw_init(jparams), tadamw.adamw_init(tparams)
    program = ttrain.TrainProgram(Model(cfg, device="cpu"), tadamw.AdamWConfig(**opt), tparams, tstate,
                                  (2, 24))
    data = jpipe.SyntheticCorpus(jpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=24, batch_size=2))
    jl, tl = [], []
    for _ in range(3):
        b = data.batch()
        jparams, jstate, jloss = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tparams, tstate, tloss = program(tparams, tstate, {k: torch.from_numpy(v.astype(np.int64))
                                                           for k, v in b.items()})
        jl.append(float(jloss))
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert tl[-1] != tl[0]


@pytest.mark.parametrize("other", ["params", "opt_state", "a copy of the params"])
def test_program_refuses_other_trees(other):
    """A graph reads the tensors it captured: calling the program with a
    tree it was not built with raises, and steps nothing."""
    cfg = dataclasses.replace(get_config("orloj_gpt").reduced(), n_layers=1)
    model = Model(cfg, device="cpu")
    params, state = _state(model, 3)
    program = ttrain.TrainProgram(model, _opt(), params, state, (2, 20))
    fresh_params, fresh_state = _state(model, 3)
    args = {"params": (fresh_params, state), "opt_state": (params, fresh_state),
            "a copy of the params": (dict(params), state)}[other]
    with pytest.raises(ValueError, match="it was built with"):
        program(*args, _batches(cfg, 1)[0])
    assert int(state["step"]) == 0 and int(fresh_state["step"]) == 0


def test_program_copies_each_batch_into_its_static_buffers():
    """The body reads the program's own int64 buffers, which hold the last
    batch given; the caller's tensors are not kept."""
    cfg = dataclasses.replace(get_config("orloj_gpt").reduced(), n_layers=1)
    model = Model(cfg, device="cpu")
    params, state = _state(model, 4)
    program = ttrain.TrainProgram(model, _opt(), params, state, (2, 20))
    tokens, labels = program.tokens, program.labels
    for batch in _batches(cfg, 2):
        program(params, state, {k: v.int() for k, v in batch.items()})
        assert program.tokens is tokens and program.labels is labels
        assert tokens.dtype == torch.int64 and torch.equal(tokens, batch["tokens"])
        assert torch.equal(labels, batch["labels"])


def test_train_runs_its_steps_through_the_program():
    """``train`` on one device steps a TrainProgram built over the final
    parameters and optimizer state it records."""
    rec = {}
    cfg = dataclasses.replace(get_config("orloj_gpt").reduced(), n_layers=1)
    ttrain.train(cfg, steps=2, batch=2, seq=8, log_every=1, device="cpu", record=rec)
    program = rec["train_step"]
    assert isinstance(program, ttrain.TrainProgram)
    assert program.params is rec["params"] and program.opt_state is rec["opt_state"]
    assert tuple(program.tokens.shape) == (2, 8)


# ------------------------------------------------------------------ AdamW
def test_adamw_update_advances_step_in_place():
    """``adamw_update`` returns the state it was given, its ``step`` the same
    int32 tensor advanced by one (a captured graph reads that tensor)."""
    params = {"a": torch.ones(3), "b": [torch.ones(2, 2)]}
    state = tadamw.adamw_init(params)
    step = state["step"]
    for want in (1, 2):
        _, got = tadamw.adamw_update(tadamw.AdamWConfig(), params, {"a": torch.ones(3),
                                                                    "b": [torch.ones(2, 2)]}, state)
        assert got is state and got["step"] is step
        assert step.dtype == torch.int32 and int(step) == want


def test_adamw_update_refuses_mismatched_trees_before_stepping():
    params = {"a": torch.ones(3), "b": [torch.ones(2, 2)]}
    state = tadamw.adamw_init(params)
    with pytest.raises(ValueError, match="gradients"):
        tadamw.adamw_update(tadamw.AdamWConfig(), params, [torch.ones(3)], state)
    assert int(state["step"]) == 0


# ----------------------------------------------------------------- corpus
@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (151_552, 48, 2, 0),  # GLM-4-9B's vocabulary
    (32_000, 64, 4, 1),
    (1_000, 32, 3, 7),
    (50_304, 40, 2, 11),
    (17, 100, 3, 2),  # a vocabulary smaller than the successor table's reach
])
def test_cdf_corpus_gives_the_synthetic_corpus_stream(vocab, seq, batch, seed):
    """Three batches of ``CdfCorpus`` and ``SyntheticCorpus`` from the same
    config: tokens and labels equal, and both generators at the same point
    after them."""
    cfg = tpipe.DataConfig(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed)
    want, got = tpipe.SyntheticCorpus(cfg), tpipe.CdfCorpus(cfg)
    for _ in range(3):
        w, g = want.batch(), got.batch()
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
    assert got.rng.random() == want.rng.random()


def test_cdf_corpus_unigram_draws_equal_generator_choice():
    """2,000 unigram draws at GLM-4's vocabulary, one search a draw, equal
    ``Generator.choice(V, p=unigram)`` from the same seed."""
    cfg = tpipe.DataConfig(vocab_size=151_552, seq_len=4, batch_size=1)
    corpus = tpipe.CdfCorpus(cfg)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    got = [int(corpus.cdf.searchsorted(a.random(), side="right")) for _ in range(2000)]
    want = [int(b.choice(cfg.vocab_size, p=corpus.unigram)) for _ in range(2000)]
    assert got == want and a.random() == b.random()
    assert corpus.cdf[-1] == 1.0 and np.all(np.diff(corpus.cdf) >= 0)


def test_train_iterator_draws_from_the_cdf_corpus(monkeypatch):
    made = []

    class Recording(tpipe.CdfCorpus):
        def __init__(self, cfg):
            super().__init__(cfg)
            made.append(self)

    monkeypatch.setattr(tpipe, "CdfCorpus", Recording)
    cfg = tpipe.DataConfig(vocab_size=100, seq_len=8, batch_size=2, seed=4)
    got = next(tpipe.make_train_iterator(cfg, "cpu"))
    assert len(made) == 1
    want = tpipe.SyntheticCorpus(cfg).batch()
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
