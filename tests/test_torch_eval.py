"""The port's engine substrate and grid runner (``repro_torch.eval``) against
the reference's (``repro.eval``), on the CPU.

Everything upstream of execution must be the reference's: for one fixed
latency model the port builds the reference's request set bit for bit, and
its Eq.-3 sim twin gives the reference's outcome exactly.  Cells served on
the two real engines are measurements and differ; what must hold is the
timing-robust invariant of DESIGN.md §8 (same seed, a generous SLO → the
same finish set) and the shape of what a cell reports.  The tests that
build an engine are marked ``slow``, as the reference's are.
"""

import dataclasses
import inspect
import json
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.eval.substrate as jsub  # noqa: E402
import repro_torch.eval.substrate as tsub  # noqa: E402
from repro.core.eventloop import run_event_loop as j_run_event_loop  # noqa: E402
from repro.eval import ExperimentSpec as JSpec  # noqa: E402
from repro.eval import run_spec as j_run_spec  # noqa: E402
from repro.eval.grid import engine_smoke as j_engine_smoke  # noqa: E402
from repro.eval.grid import multi_model_smoke as j_multi_model_smoke  # noqa: E402
from repro.eval.spec import TIMING_FIELDS  # noqa: E402
from repro.serving.residency import zoo_profile as j_zoo_profile  # noqa: E402
from repro_torch.core.distributions import BatchLatencyModel  # noqa: E402
from repro_torch.core.eventloop import run_event_loop  # noqa: E402
from repro_torch.eval import ExperimentSpec, evaluate_claims, run_spec  # noqa: E402
from repro_torch.eval.grid import engine_smoke, multi_model_smoke  # noqa: E402
from repro_torch.eval.run import DEFAULT_OUT  # noqa: E402
from repro_torch.eval.run import main as run_main  # noqa: E402
from repro_torch.eval.runner import read_artifact  # noqa: E402
from repro_torch.serving.residency import DEFAULT_ROSTER, zoo_profile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOY = tsub.ENGINE_MODELS["orloj_gpt"]
LM = BatchLatencyModel(c0=2.5, c1=0.04, bucket=0.0)  # one fixed curve for both sides


@pytest.fixture
def on_cpu():
    """Engine cells on the CPU for the test, the card again after it."""
    tsub.set_engine_device("cpu")
    yield
    tsub.set_engine_device("cuda")


def _pairs():
    """The engine-smoke cells and one of the reference engine tests' cells,
    each as (port spec, reference spec)."""
    extra = dict(workload="bimodal", workload_params={"std": 1.0}, slo_scale=5.0,
                 utilization=0.5, n_requests=32, seed=3, substrate="engine", tag="engine/unit")
    return list(zip(engine_smoke(), j_engine_smoke())) + [(ExperimentSpec(**extra), JSpec(**extra))]


def _request_sets(spec, jspec):
    ours = tsub.build_engine_request_set(spec, TOY.buckets, TOY.batch_sizes, LM, 256)
    theirs = jsub.build_engine_request_set(jspec, TOY.buckets, TOY.batch_sizes, LM, 256)
    return ours, theirs


@pytest.mark.parametrize("i", range(5))
def test_engine_request_set_is_the_references(i):
    spec, jspec = _pairs()[i]
    assert spec.to_dict() == jspec.to_dict()
    ours, theirs = _request_sets(spec, jspec)
    assert ours.fingerprint() == theirs.fingerprint()
    assert ours.p99_alone == theirs.p99_alone
    assert [(r.app_id, r.release, r.slo, r.true_time) for r in ours.requests] == [
        (r.app_id, r.release, r.slo, r.true_time) for r in theirs.requests
    ]
    for a, b in zip(ours.requests, theirs.requests):
        assert a.payload.dtype == b.payload.dtype
        np.testing.assert_array_equal(a.payload, b.payload)
    assert ours.app_history.keys() == theirs.app_history.keys()
    for app in ours.app_history:
        np.testing.assert_array_equal(ours.app_history[app], theirs.app_history[app])


@pytest.mark.parametrize("i", range(5))
def test_sim_twin_outcome_is_the_references(i):
    """The Eq.-3 twin of a cell, on the port's copies and on the reference:
    the same finish rate, finish set and drops."""
    spec, jspec = _pairs()[i]
    ours, theirs = _request_sets(spec, jspec)
    engine = types.SimpleNamespace(cfg=types.SimpleNamespace(buckets=TOY.buckets))
    outcome = []
    for sub, s, rs, loop in ((tsub, spec, ours, run_event_loop), (jsub, jspec, theirs, j_run_event_loop)):
        served = rs.fresh()
        res = loop(served, sub._pool(s, LM, rs, engine, TOY.batch_sizes, predicted=True),
                   policy=s.policy, charge_scheduler_overhead=s.charge_overhead, seed=s.seed)
        outcome.append((res.finish_rate, res.n_finished_ok, res.n_dropped, res.n_batches,
                        [j for j, r in enumerate(served) if r.ok]))
    assert outcome[0] == outcome[1]
    assert outcome[0][1] > 0


def test_substrate_shares_the_references_code_line_for_line():
    """Only the engine's construction differs: the registry, the request
    mapping, the sim twin, the cell and the drift report are the reference's."""
    for name in ("parse_substrate", "_snap_lengths", "build_engine_request_set",
                 "_PredictedExecutor", "run_engine_spec", "drift_report"):
        assert inspect.getsource(getattr(tsub, name)) == inspect.getsource(getattr(jsub, name)), name
    pool = inspect.getsource(tsub._pool).replace("TorchServingEngine", "ServingEngine")
    assert pool == inspect.getsource(jsub._pool)
    assert tsub.ENGINE_MODELS == {
        k: tsub.EngineModelSpec(**dataclasses.asdict(v)) for k, v in jsub.ENGINE_MODELS.items()
    }
    assert tsub.DEFAULT_ENGINE_MODEL == jsub.DEFAULT_ENGINE_MODEL


def test_engine_device_is_the_card_and_checked():
    assert tsub._ENGINE_DEVICE == "cuda"
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tsub.set_engine_device("mps")


def test_engine_cell_on_the_card_raises_without_one(monkeypatch):
    """An engine cell asks for the card by default; without one it raises
    (no quiet fall back to the CPU), and no engine is cached."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = engine_smoke()[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_spec(spec)
    assert ("orloj_gpt", "cuda") not in tsub._ENGINE_CACHE


@pytest.mark.parametrize("arch", DEFAULT_ROSTER)
def test_zoo_profile_is_the_references(arch):
    """The multi-model grids price each roster model by ``zoo_profile``:
    with the whole zoo in the port's registry, every entry is the
    reference's."""
    assert dataclasses.asdict(zoo_profile(arch)) == dataclasses.asdict(j_zoo_profile(arch))


def test_multi_model_smoke_cell_is_the_references():
    """A multi-model-smoke cell whose 4-model roster holds InternVL2, Hymba
    and xLSTM (the cold-start sweep under the residency policy), on the sim
    substrate: the port's outcome is the reference's, bit for bit."""
    (spec,) = [s for s in multi_model_smoke() if s.tag == "mm/coldstart/residency/s7"]
    (jspec,) = [s for s in j_multi_model_smoke() if s.tag == spec.tag]
    assert spec.to_dict() == jspec.to_dict() and spec.n_models == 4
    ours, theirs = run_spec(spec).to_dict(), j_run_spec(jspec).to_dict()
    for timing in TIMING_FIELDS:
        ours.pop(timing), theirs.pop(timing)
    assert ours == theirs
    assert ours["n_finished_ok"] > 0


def _cell_spec(mod, **kw):
    base = dict(workload="bimodal", workload_params={"std": 1.0}, slo_scale=50.0,
                utilization=0.3, n_requests=32, seed=3, substrate="engine", tag="engine/unit")
    base.update(kw)
    return mod(**base)


@pytest.fixture(scope="module")
def cells():
    """One port cell (engine on the CPU) and one reference cell of the same
    seed at a generous SLO."""
    tsub.set_engine_device("cpu")
    try:
        ours = run_spec(_cell_spec(ExperimentSpec))
    finally:
        tsub.set_engine_device("cuda")
    return ours, j_run_spec(_cell_spec(JSpec))


@pytest.mark.slow
def test_engine_cell_reports_what_the_references_does(cells):
    ours, theirs = cells
    assert ours.spec.substrate == "engine" and ours.n_total == 32
    assert ours.n_finished_ok + ours.n_finished_late + ours.n_dropped + ours.n_unserved == 32
    m = ours.substrate_meta
    assert m.keys() == theirs.substrate_meta.keys()
    assert m["sim_twin"].keys() == theirs.substrate_meta["sim_twin"].keys()
    assert m["model"] == "orloj_gpt" and m["model_name"] == theirs.substrate_meta["model_name"]
    assert m["c0_ms"] > 0 and m["c1_ms_per_token"] > 0 and m["n_batches"] > 0
    assert m["buckets"] == [8, 16, 24, 32] and m["batch_sizes"] == [1, 2, 4]
    assert len(m["finish_idx"]) == ours.n_finished_ok
    assert ours.latency_p99_ms >= ours.latency_p50_ms > 0.0
    assert json.loads(json.dumps(ours.to_dict())) == ours.to_dict()


@pytest.mark.slow
def test_generous_slo_finishes_the_references_set(cells):
    """DESIGN.md §8's timing-robust invariant across the two engines: at
    SLO 50× and utilization 0.3 the port's cell and the reference's cell of
    the same seed finish the same requests."""
    ours, theirs = cells
    assert ours.substrate_meta["finish_idx"] == theirs.substrate_meta["finish_idx"]
    assert ours.n_finished_ok == theirs.n_finished_ok > 0


@pytest.mark.slow
def test_engine_cells_feed_claims_and_drift_unmodified(on_cpu):
    results = [run_spec(_cell_spec(ExperimentSpec, system=s, slo_scale=1.5, tag=f"engine/unit/{s}"))
               for s in ("orloj", "nexus")]
    assert [c.name for c in evaluate_claims(results)] == ["tight-slo-dominance"]
    drift = tsub.drift_report(results)
    assert drift is not None and drift["n_cells"] == 2
    assert {c["tag"] for c in drift["cells"]} == {"engine/unit/orloj", "engine/unit/nexus"}
    assert drift.keys() == jsub.drift_report(results).keys()


@pytest.mark.slow
def test_cli_engine_smoke_on_the_cpu_writes_engine_cells(tmp_path, capsys, on_cpu):
    out = tmp_path / "grid.json"
    rc = run_main(["--grid", "engine-smoke", "--jobs", "1", "--device", "cpu", "--out", str(out)])
    assert rc == 0  # tracked, not gated
    assert tsub._ENGINE_DEVICE == "cpu"
    doc, results = read_artifact(str(out))
    assert doc["grid"] == "engine-smoke" and len(results) == 4
    assert all(r.spec.substrate == "engine" for r in results)
    assert doc["engine_drift"]["n_cells"] == 4
    assert {c["name"] for c in doc["claims"]} >= {"tight-slo-dominance"}
    assert "engine drift: 4 cells" in capsys.readouterr().out


def test_cli_does_not_default_to_the_references_artifact(monkeypatch, on_cpu):
    """The default ``--out`` lies under the checkout's git-ignored build/,
    not on the reference's BENCH_eval.json; the default device is the card."""
    seen = {}

    def stand_in(specs, jobs):
        seen["device"] = tsub._ENGINE_DEVICE
        raise SystemExit(0)

    import repro_torch.eval.run as run_mod

    monkeypatch.setattr(run_mod, "run_specs", stand_in)
    with pytest.raises(SystemExit):
        run_main(["--grid", "engine-smoke"])
    assert seen["device"] == "cuda"
    assert DEFAULT_OUT.name != "BENCH_eval.json" and DEFAULT_OUT.parent == ROOT / "build"
