"""The serving executors' static state and launch accounting, on the CPU.

On a CUDA device every served shape of the port's executors is a captured
CUDA graph over static tensors; on the CPU the same bodies run eagerly.
These tests hold what the graphs rely on where a CPU can show it: the
decode executor keeps its state in the same tensors through a whole run
(equal to the reference's ``DecodeJaxExecutor`` step for step), the
prefill executor's per-shape token buffers give each call its own logits,
and the launch counters' capture and replay arithmetic.  The replays
themselves are held on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving.engine import DecodeJaxExecutor, ServingEngine  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import from_numpy  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    DecodeTorchExecutor,
    EngineConfig,
    TorchServingEngine,
)

TINY = ModelConfig(
    name="tiny",
    arch_type="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    dtype="float32",
    scan_layers=False,
)
ECFG = EngineConfig(buckets=(16, 32), batch_sizes=(1, 2, 4), profile_reps=2)


# ---------------------------------------------------------------- decode
def test_calibrate_restores_the_decode_state_in_the_same_tensors():
    dec = DecodeTorchExecutor(TINY, max_batch=3, max_cache=16, seed=2, device="cpu")
    dec._valid = torch.tensor([4, 0, 16], dtype=torch.int32)
    dec._decode_once()
    state = (dec._kc, dec._vc, dec._valid)
    ptrs = [t.data_ptr() for t in state]
    want = [t.clone() for t in state]
    assert dec.calibrate(reps=2) > 0.0
    after = (dec._kc, dec._vc, dec._valid)
    assert all(a is b for a, b in zip(after, state))
    assert [t.data_ptr() for t in after] == ptrs
    for got, w in zip(after, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_valid_assignment_copies_into_the_static_tensor():
    dec = DecodeTorchExecutor(TINY, max_batch=2, max_cache=8, device="cpu")
    valid = dec._valid
    dec._valid = torch.tensor([3, 8], dtype=torch.int32)
    assert dec._valid is valid and dec._valid.tolist() == [3, 8]
    dec._valid = torch.full_like(valid, 5)
    assert dec._valid is valid and dec._valid.tolist() == [5, 5]


def _requests(n: int, prompts) -> list[Request]:
    return [Request(app_id="tok", release=0.0, slo=1.0, true_time=1.0, prompt_tokens=p)
            for p in prompts[:n]]


def test_decode_steps_with_joins_and_departures_match_the_jax_executor():
    """One sequence of ``step_time`` calls (joins, a departure, a rejoin into
    the freed slot, a slot past ``max_cache`` writing at 0) through both
    executors from one seed, each wired to its engine's prefill executor:
    after every step ``_valid``, the K cache and ``last_out`` are the
    reference's (its jnp oracle path; tolerances of
    ``test_decode_step_matches_the_jax_executor``), and the port's state
    stays in the tensors it was built with."""
    torch_engine = TorchServingEngine(TINY, ECFG, device="cpu")
    jax_engine = ServingEngine(TINY, ECFG)
    ours = torch_engine.decode_executor(max_batch=3, max_cache=8, seed=11)
    theirs = DecodeJaxExecutor(TINY, max_batch=3, max_cache=8, prefill=jax_engine.executor,
                               use_pallas=False, seed=11)
    ptrs = [t.data_ptr() for t in (ours._kc, ours._vc, ours._valid)]
    a, b, c, d = _requests(4, [5, 12, 3, 7])  # b's prompt overflows the 8-slot cache
    steps = [([a], [a]), ([a, b], [b]), ([a, b], []), ([a, b, c], [c]), ([b, c], []),
             ([b, c, d], [d]), ([b, c, d], []), ([c, d], []), ([c, d], [])]
    for i, (active, joined) in enumerate(steps):
        for dec in (ours, theirs):
            assert dec.step_time(active, joined, now=float(i)) > 0.0
        np.testing.assert_array_equal(np.asarray(ours._valid), np.asarray(theirs._valid))
        np.testing.assert_array_equal(np.asarray(ours._kc), np.asarray(theirs._kc))
        np.testing.assert_allclose(np.asarray(ours.last_out), np.asarray(theirs.last_out),
                                   rtol=2e-5, atol=1e-6)
    assert int(ours._valid.max()) == 8 and ours._slot == theirs._slot
    assert [t.data_ptr() for t in (ours._kc, ours._vc, ours._valid)] == ptrs


# --------------------------------------------------------------- prefill
def test_prefill_shapes_keep_their_own_token_buffers():
    """X, then Y, then X again with other tokens: each call's logits are
    ``model.logits`` on that call's (padded) tokens, and each shape keeps
    one buffer."""
    engine = TorchServingEngine(TINY, ECFG, device="cpu")
    ex = engine.executor
    rng = np.random.default_rng(3)
    calls = [rng.integers(1, 256, size=shape).astype(np.int32) for shape in ((3, 16), (1, 32), (4, 16))]
    buffers = {}
    for tokens in calls:
        ms, k = ex._run(tokens)
        padded = np.zeros((k, tokens.shape[1]), np.int64)
        padded[: tokens.shape[0]] = tokens
        with torch.no_grad():
            want = engine.model.logits(engine.params, {"tokens": torch.from_numpy(padded)})
        torch.testing.assert_close(ex.last_logits, want, rtol=0, atol=0)
        static = ex._shapes[(k, tokens.shape[1])][0]
        buffers.setdefault((k, tokens.shape[1]), static)
        assert static is buffers[(k, tokens.shape[1])]
        np.testing.assert_array_equal(static.numpy(), padded)
    assert set(ex._warm) == {(4, 16), (1, 32)}


def test_executor_params_are_read_only():
    engine = TorchServingEngine(TINY, ECFG, device="cpu")
    assert engine.executor.params is engine.params
    with pytest.raises(AttributeError):
        engine.executor.params = {}


def test_prefill_logits_equal_the_jax_executors_through_the_buffers():
    """Reference weights converted to the port: the logits of two shapes,
    each called twice, equal the reference model's logits on the same
    tokens (float32 to 1e-4: another order of summation)."""
    jax_engine = ServingEngine(TINY, ECFG)
    params = from_numpy(jax.tree.map(np.asarray, jax_engine.params), TINY, device="cpu")
    ex = TorchServingEngine(TINY, ECFG, device="cpu", params=params).executor
    rng = np.random.default_rng(4)
    for shape in ((2, 16), (4, 32), (2, 16), (4, 32)):
        tokens = rng.integers(1, 256, size=shape).astype(np.int32)
        ex._run(tokens)
        want = jax_engine.model.logits(jax_engine.params, {"tokens": jnp.asarray(tokens)})
        np.testing.assert_allclose(ex.last_logits.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ launch accounting
def test_a_capture_adds_no_launches_and_each_replay_adds_the_captured():
    ops.reset_launch_counts()
    fa_mod.launches += 2  # launches before the capture stay
    with ops.captured_launches() as captured:
        fa_mod.launches += 3  # the wrappers' host calls inside a capture
        rms_mod.launches += 5
        assert captured == {}
    assert captured == {"flash_attention": 3, "rmsnorm": 5}
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 and counts["rmsnorm"] == 0
    for _ in range(2):
        ops.add_launches(captured)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 + 2 * 3 and counts["rmsnorm"] == 2 * 5
    assert counts["decode_attention"] == 0
    ops.reset_launch_counts()


def test_a_failed_capture_takes_its_counts_back():
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        with ops.captured_launches() as captured:
            dec_mod.launches += 1
            raise RuntimeError("capture failed")
    assert ops.launch_counts()["decode_attention"] == 0 and captured == {"decode_attention": 1}


def test_cpu_executors_run_their_bodies_eagerly():
    """On the CPU a program is its body: no graph, and the decode executor's
    warm-up step ran at construction as the reference's does."""
    dec = DecodeTorchExecutor(dataclasses.replace(TINY, n_layers=1), max_batch=2, max_cache=8,
                              device="cpu")
    assert dec._program.graph is None
    engine = TorchServingEngine(TINY, ECFG, device="cpu")
    engine.executor._run(np.ones((1, 16), np.int32))
    assert all(p.graph is None for _, p in engine.executor._shapes.values())
