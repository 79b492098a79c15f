"""The port's serving engine on the CPU, against the JAX engine, plus the
guards that keep the port standing alone.

The engine runs with ``device="cpu"`` on the TINY config of
``tests/test_engine.py``; every part upstream of execution (requests,
payloads, the decode executor's synthetic draws) must equal the JAX
engine's for a seed.
"""

import ast
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as jax_serve  # noqa: E402
import repro_torch.launch.serve as torch_serve  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.serving.engine import DecodeJaxExecutor, ServingEngine  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import EmpiricalDistribution, OrlojScheduler, SchedulerConfig  # noqa: E402
from repro_torch.core.tokensched import (  # noqa: E402
    FcfsTokenScheduler,
    LengthAwareTokenScheduler,
    TokenSchedConfig,
)
from repro_torch.launch.serve import length_sampler, make_scheduler  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    DecodeTorchExecutor,
    EngineConfig,
    TorchServingEngine,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent

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


@pytest.fixture(scope="module")
def engine():
    return TorchServingEngine(TINY, ECFG, device="cpu")


# ---------------------------------------------------------------- engine
def test_profile_fits_eq3(engine):
    lm = engine.profile_latency_model()
    assert lm.c0 >= 0 and lm.c1 > 0
    assert lm.batch_time([32.0] * 4) > lm.batch_time([16.0])


def test_executor_reports_padded_batch_size(engine):
    ex = engine.executor
    assert ex.padded_batch_size(3) == 4 and ex.padded_batch_size(9) == 9
    ms, k_pad = ex._run(np.ones((3, 16), np.int32))
    assert k_pad == 4 and ms > 0.0
    assert (4, 16) in ex._warm  # the shape's warm-up ran outside the timing


def test_serve_end_to_end_and_measured_log(engine):
    lm = engine.profile_latency_model()
    reqs, hist = engine.make_requests(
        30, lm, length_sampler=lambda rng: int(rng.integers(4, 32)),
        slo_scale=50.0, utilization=0.3, seed=1,
    )
    dists = {a: EmpiricalDistribution.from_samples(x) for a, x in hist.items() if len(x) >= 2}
    sched = OrlojScheduler(lm, cfg=SchedulerConfig(batch_sizes=(1, 2, 4)), initial_dists=dists)
    engine.executor.drain_measured()
    res = engine.serve(reqs, sched)
    assert res.n_total == 30 and res.conserved
    assert res.n_finished_ok + res.n_finished_late + res.n_dropped == 30
    log = engine.executor.drain_measured()
    assert len(log) == res.n_batches and all(k in (1, 2, 4) and b in (16, 32) for k, b, _ in log)
    assert engine.executor.drain_measured() == []


def test_pool_serving_with_a_scaled_replica(engine):
    lm = engine.profile_latency_model()
    reqs, hist = engine.make_requests(
        20, lm, length_sampler=lambda rng: int(rng.integers(4, 32)),
        slo_scale=50.0, utilization=0.4, seed=2,
    )
    scheds = [
        OrlojScheduler(lm, cfg=SchedulerConfig(batch_sizes=(1, 2, 4)))
        for _ in range(2)
    ]
    assert engine.executor_for(1.0) is engine.executor
    with pytest.raises(ValueError):
        engine.executor_for(0.0)
    res = engine.serve_pool(reqs, scheds, executors=[engine.executor, engine.executor_for(2.0)])
    assert res.n_workers == 2 and res.n_total == 20
    assert res.utilization <= 1.0 + 1e-9


def test_make_requests_equal_the_jax_engines(engine):
    """Same latency model and seed → the same releases, SLOs, sizes and
    payloads as the reference engine."""
    jeng = ServingEngine(TINY, EngineConfig(buckets=(16, 32), batch_sizes=(1, 2, 4)))
    lm = engine.profile_latency_model()
    kw = dict(length_sampler=length_sampler, slo_scale=3.0, utilization=0.7, seed=5)
    ours, h1 = engine.make_requests(40, lm, **kw)
    theirs, h2 = jeng.make_requests(40, lm, **kw)
    for a, b in zip(ours, theirs):
        assert (a.app_id, a.release, a.slo, a.true_time) == (b.app_id, b.release, b.slo, b.true_time)
        np.testing.assert_array_equal(a.payload, b.payload)
    for app in ("short", "long"):
        np.testing.assert_array_equal(h1[app], h2[app])


# ---------------------------------------------------------------- decode
def test_decode_step_matches_the_jax_executor():
    """From one seed and one ``valid_len`` state, one step gives the
    reference's output (its jnp oracle path); the empty slot is all zero."""
    outs = {}
    for name in ("jax", "torch"):
        if name == "jax":
            dec = DecodeJaxExecutor(TINY, max_batch=2, max_cache=32, use_pallas=False, seed=7)
            dec._valid = jnp.array([5, 0], jnp.int32)
        else:
            dec = DecodeTorchExecutor(TINY, max_batch=2, max_cache=32, seed=7, device="cpu")
            dec._valid = torch.tensor([5, 0], dtype=torch.int32)
        dec._decode_once()
        outs[name] = (np.asarray(dec.last_out), np.asarray(dec._valid), np.asarray(dec._kc))
    np.testing.assert_array_equal(outs["torch"][1], outs["jax"][1])
    np.testing.assert_array_equal(outs["torch"][2], outs["jax"][2])
    np.testing.assert_allclose(outs["torch"][0], outs["jax"][0], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(outs["torch"][0][1], 0.0)


def test_decode_ring_quirk_matches_the_jax_executor():
    """A full slot (valid_len == max_cache) writes at position 0 in both."""
    outs = {}
    for name in ("jax", "torch"):
        if name == "jax":
            dec = DecodeJaxExecutor(TINY, max_batch=2, max_cache=8, use_pallas=False, seed=3)
            dec._valid = jnp.array([8, 3], jnp.int32)
        else:
            dec = DecodeTorchExecutor(TINY, max_batch=2, max_cache=8, seed=3, device="cpu")
            dec._valid = torch.tensor([8, 3], dtype=torch.int32)
        dec._decode_once()
        dec._decode_once()
        outs[name] = (np.asarray(dec.last_out), np.asarray(dec._valid), np.asarray(dec._kc))
    np.testing.assert_array_equal(outs["torch"][1], [8, 5])
    np.testing.assert_array_equal(outs["torch"][2], outs["jax"][2])
    np.testing.assert_allclose(outs["torch"][0], outs["jax"][0], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("scheduler", ["fcfs", "length_aware"])
def test_serve_tokens_finishes_every_token(engine, scheduler):
    dec = engine.decode_executor(max_batch=4, max_cache=64)
    step_ms = dec.calibrate()
    assert step_ms > 0.0
    reqs = engine.make_token_requests(24, dec, mean_out=8.0, utilization=0.5, seed=2)
    cfg = TokenSchedConfig(
        max_batch=4, ttft_slo_ms=1e6, tpot_slo_ms=1e6, d0=step_ms, d1=0.0,
    )
    sched = FcfsTokenScheduler(cfg) if scheduler == "fcfs" else LengthAwareTokenScheduler(cfg)
    res = engine.serve_tokens(reqs, sched, dec)
    assert res.n_total == 24 and res.conserved
    assert all(r.tokens_done == r.out_tokens for r in reqs)
    # the final step's finishers free their slots on the next run's first step
    reqs2 = engine.make_token_requests(8, dec, mean_out=4.0, utilization=0.5, seed=3)
    res2 = engine.serve_tokens(reqs2, FcfsTokenScheduler(cfg), dec)
    assert res2.n_total == 8 and all(r.tokens_done == r.out_tokens for r in reqs2)


def test_make_token_requests_equal_the_jax_engines(engine):
    """Token requests depend on the measured step; for a fixed step they
    are the reference's, draw for draw."""
    dec = engine.decode_executor(max_batch=4, max_cache=64)
    jdec = DecodeJaxExecutor(TINY, max_batch=4, max_cache=64, use_pallas=False)
    dec.calibrate = jdec.calibrate = lambda reps=3: 1.5
    jeng = ServingEngine(TINY, ECFG)
    ours = engine.make_token_requests(16, dec, seed=4)
    theirs = jeng.make_token_requests(16, jdec, seed=4)
    assert [(r.release, r.slo, r.prompt_tokens, r.out_tokens) for r in ours] == [
        (r.release, r.slo, r.prompt_tokens, r.out_tokens) for r in theirs
    ]


def test_serve_tokens_rejects_oversized_scheduler(engine):
    dec = engine.decode_executor(max_batch=2, max_cache=32)
    with pytest.raises(ValueError, match="cache slots"):
        engine.serve_tokens([], FcfsTokenScheduler(TokenSchedConfig(max_batch=8)), dec)


@pytest.mark.parametrize("name", ["orloj", "clockwork", "nexus", "clipper", "edf"])
def test_serve_cli_builds_every_scheduler(name):
    from repro_torch.core.distributions import BatchLatencyModel

    hist = {"short": np.array([32.0, 32.0, 64.0]), "long": np.array([256.0, 256.0])}
    sched = make_scheduler(name, BatchLatencyModel(c0=1.0, c1=0.01, bucket=0.0), hist, (1, 2, 4, 8))
    assert sched is not None


class _Picked(Exception):
    """Raised by a stand-in engine to stop a CLI once it has chosen its config."""


def _config_picked_by(module, engine_attr, argv, monkeypatch):
    picked = {}

    def stand_in(cfg, *args, **kwargs):
        picked["cfg"] = cfg
        raise _Picked

    monkeypatch.setattr(module, engine_attr, stand_in)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(_Picked):
        module.main()
    return picked["cfg"]


@pytest.mark.parametrize("arch", ["arctic_480b", "orloj_gpt"])
def test_serve_cli_sizes_a_model_as_the_jax_cli_does(arch, monkeypatch):
    """Above 500 M parameters both CLIs serve ``reduced()`` with a vocabulary
    of at most 8192; orloj_gpt (134 M) is served whole."""
    theirs = _config_picked_by(jax_serve, "ServingEngine", ["--arch", arch], monkeypatch)
    ours = _config_picked_by(torch_serve, "TorchServingEngine", ["--arch", arch], monkeypatch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if arch == "arctic_480b":
        assert ours.n_experts == 4 and ours.vocab_size == 8192 and ours.d_model == 256


def test_serve_cli_serves_reduced_arctic_on_the_cpu(capsys):
    torch_serve.main(["--arch", "arctic_480b", "--device", "cpu", "--n", "6", "--scheduler", "edf"])
    out = capsys.readouterr().out
    assert "profiling arctic-480b-smoke latency curve on cpu" in out
    assert "Eq.3 fit" in out and "edf" in out


# ---------------------------------------------------------------- guards
def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchServingEngine(TINY, ECFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeTorchExecutor(TINY)


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted((ROOT / "scripts").glob("*.py"))


def test_port_imports_no_jax_and_nothing_of_the_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "flax", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert bad == []
    assert len(_port_files()) > 20
    covered = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"src/repro_torch/models/moe.py", "src/repro_torch/kernels/rmsnorm.py",
            "src/repro_torch/kernels/moe_gating.py", "src/repro_torch/configs/arctic_480b.py",
            "src/repro_torch/configs/glm4_9b.py", "scripts/gating_variants.py",
            "src/repro_torch/eval/substrate.py", "src/repro_torch/eval/run.py",
            "src/repro_torch/serving/cluster.py", "src/repro_torch/models/ssm.py",
            "src/repro_torch/optim/adamw.py", "src/repro_torch/data/pipeline.py",
            "src/repro_torch/checkpoint/store.py", "src/repro_torch/launch/train.py",
            "src/repro_torch/optim/__init__.py", "src/repro_torch/data/__init__.py",
            "src/repro_torch/checkpoint/__init__.py", "scripts/kernel_table.py"} <= covered


COPIES = [f"core/{m}.py" for m in (
    "__init__", "request", "distributions", "eventwheel", "requeststore", "hull",
    "priority", "profiler", "scheduler", "baselines", "eventloop", "tokensched", "simulator",
)] + [f"serving/{m}.py" for m in ("batcher", "faults", "workload", "residency", "trace", "cluster")] + [
    f"eval/{m}.py" for m in ("__init__", "spec", "workloads", "runner", "grid", "claims", "sched_gate")
] + ["models/config.py"] + [
    f"configs/{m}.py" for m in (
        "orloj_gpt", "arctic_480b", "glm4_9b", "dbrx_132b", "granite_34b", "olmo_1b",
        "nemotron_4_340b", "hymba_1_5b", "xlstm_1_3b", "internvl2_1b", "musicgen_large",
        "__init__",
    )
]


# The port's copies that add to the reference's: each keeps every line of the
# reference's in order, except the lines holding the word given here, which
# the port rewrites (the event loop splits its scheduler meter by hook and
# records into a span log, ``repro_torch.core.spans``).
EXTENDED = {"core/eventloop.py": "sched_time"}


@pytest.mark.parametrize("rel", COPIES)
def test_framework_free_copies_are_byte_identical(rel):
    ours = (ROOT / "src" / "repro_torch" / rel).read_bytes()
    theirs = (ROOT / "src" / "repro" / rel).read_bytes()
    if rel not in EXTENDED:
        assert ours == theirs, f"src/repro_torch/{rel} drifted from src/repro/{rel}"
        return
    import difflib

    a, b = theirs.decode().splitlines(), ours.decode().splitlines()
    taken = [line for tag, i1, i2, _, _ in difflib.SequenceMatcher(None, a, b, autojunk=False)
             .get_opcodes() if tag in ("delete", "replace") for line in a[i1:i2]]
    assert all(EXTENDED[rel] in line for line in taken), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: "
        f"{[line for line in taken if EXTENDED[rel] not in line][:5]}")


def test_port_archs_are_the_reference_archs_in_order():
    """The port's registry is the reference's, in its order, and every name
    resolves to the reference's configuration."""
    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
