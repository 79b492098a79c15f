"""The port's span log (``repro_torch.core.spans``) and what records into it:
the event loop's per-hook meters and spans, the serving executor's and the
Eq.-3 fit's spans, and the clock they share with ``torch.profiler``."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    BatchLatencyModel,
    EmpiricalDistribution,
    ModelExecutor,
    OrlojScheduler,
    SchedulerConfig,
    Worker,
    run_event_loop,
)
from repro_torch.core import spans as sp  # noqa: E402
from repro_torch.core.eventloop import HOOKS, DecodeModelExecutor  # noqa: E402
from repro_torch.core.tokensched import FcfsTokenScheduler, TokenSchedConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.engine import EngineConfig, TorchServingEngine  # noqa: E402
from repro_torch.serving.trace import TraceConfig, generate_requests  # noqa: E402
from repro_torch.serving.workload import bimodal  # noqa: E402

LM = BatchLatencyModel(c0=25.0, c1=1.0)
TINY = ModelConfig(name="tiny", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32", scan_layers=False)
ECFG = EngineConfig(buckets=(16, 32), batch_sizes=(1, 2, 4), profile_reps=2)


def _trace(n=300, seed=11):
    return generate_requests(bimodal(1.0), LM, slo_scale=3.0,
                             cfg=TraceConfig(n_requests=n, seed=seed, utilization=0.9))


# ------------------------------------------------------------- the log
def test_ring_keeps_the_newest_and_whole_totals():
    log = sp.SpanLog(capacity=4)
    for i in range(6):
        log.add(sp.EXEC_PAD if i % 2 else sp.EXEC_H2D, 10 * i, 10 * i + 3, i)
    assert log.n == 6 and log.dropped == 2
    assert log.calls[sp.EXEC_PAD] == 3 and log.ns[sp.EXEC_PAD] == 9
    np.testing.assert_array_equal(log.intervals([sp.EXEC_PAD, sp.EXEC_H2D])[:, 2], [2, 3, 4, 5])
    np.testing.assert_array_equal(log.intervals(sp.EXEC_PAD), [[30, 33, 3], [50, 53, 5]])
    assert log.intervals(sp.ENGINE_FIT).shape == (0, 3)
    with pytest.raises(KeyError):
        log.add("exec.other", 0, 1)
    with pytest.raises(KeyError):
        log.intervals("exec.other")
    assert log.n == 6


def test_covered_counts_only_the_gaps_under_the_spans():
    log = sp.SpanLog()
    for s, e in ((100, 200), (150, 260), (400, 500)):  # two overlap: one union
        log.add(sp.SCHED_NEXT_BATCH, s, e)
    log.add(sp.EXEC_REPLAY, 600, 700)
    log.add(sp.SCHED_ON_ARRIVAL, 0, 1000)  # not asked for
    gaps = np.array([[0, 120], [240, 420], [450, 460], [520, 650], [900, 950]])
    # under the sched spans: 100-120, 240-260, 400-420, 450-460
    assert log.covered_ns(sp.SCHED_NEXT_BATCH, gaps) == 20 + 20 + 20 + 10
    assert log.covered_ns(sp.CHARGED, gaps) == 70 + 50
    assert log.covered_ns(sp.SCHED_ON_ARRIVAL, gaps) == int((gaps[:, 1] - gaps[:, 0]).sum())
    assert log.covered_ns(sp.ENGINE_FIT, gaps) == 0
    assert log.covered_ns(sp.SCHED_NEXT_BATCH, np.zeros((0, 2))) == 0


def test_a_profiled_op_falls_inside_a_span_around_it():
    """Kineto stamps CPU and device records in the host's wall-clock ns, the
    clock of the log's spans: both ways a span is stamped (the executor's
    reads around the work, the loop's own meter closed at its end) hold the
    op that ``torch.profiler`` recorded."""
    log = sp.SpanLog()
    a = torch.randn(192, 192)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        start = time.time_ns()
        a @ a
        log.add(sp.EXEC_REPLAY, start, time.time_ns())
        t0 = time.perf_counter()
        torch.mm(a, a)
        log.close(sp.SCHED_NEXT_BATCH, time.perf_counter() - t0)
    mm = [(e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 2
    for (s, e), name in zip(sorted(mm), (sp.EXEC_REPLAY, sp.SCHED_NEXT_BATCH)):
        (lo, hi, _), = log.intervals(name)
        assert lo <= s < e <= hi, (name, s - lo, hi - e)


# ------------------------------------------------------------- the loops
@pytest.mark.parametrize("engine", ["scalar", "array"])
def test_hook_totals_sum_to_the_scheduler_time(engine):
    rs = _trace()
    res = run_event_loop(rs.fresh(), [Worker(OrlojScheduler(LM, initial_dists=rs.initial_dists()),
                                             ModelExecutor(LM))],
                         engine=engine, charge_scheduler_overhead=True)
    assert set(res.hook_ms) == set(res.hook_calls) == set(HOOKS)
    assert sum(res.hook_ms.values()) == pytest.approx(res.sched_time_ms, rel=1e-12)
    assert res.hook_calls["next_batch"] == res.n_decisions > 0
    assert res.hook_calls["on_arrival"] == res.n_total  # each request delivered once
    assert res.hook_calls["on_batch_done"] == res.n_batches
    assert res.hook_calls["on_decode_step"] == 0 and res.hook_ms["on_decode_step"] == 0.0
    assert res.spans is None


@pytest.mark.parametrize("engine", ["scalar", "array"])
def test_decode_steps_are_metered_apart(engine):
    rs = _trace(n=60)
    for r in rs.requests:
        r.prompt_tokens, r.out_tokens = 16, 4
    cfg = TokenSchedConfig(max_batch=4, ttft_slo_ms=1e6, tpot_slo_ms=1e6, d0=5.0, d1=0.0)
    res = run_event_loop(rs.fresh(), [Worker(FcfsTokenScheduler(cfg),
                                             DecodeModelExecutor(d0=5.0, d1=0.1))], engine=engine)
    assert res.hook_calls["on_decode_step"] > 0
    assert res.hook_calls["next_batch"] + res.hook_calls["on_decode_step"] == res.n_decisions
    assert sum(res.hook_ms.values()) == pytest.approx(res.sched_time_ms, rel=1e-12)


def test_scalar_loop_records_hooks_waits_and_batch_sizes():
    rs = _trace()
    reqs = rs.fresh()
    log = sp.SpanLog()
    res = run_event_loop(reqs, [Worker(OrlojScheduler(LM, initial_dists=rs.initial_dists()),
                                       ModelExecutor(LM))],
                         charge_scheduler_overhead=True, spans=log)
    assert res.spans is log
    for hook, name in zip(HOOKS, (sp.SCHED_NEXT_BATCH, sp.SCHED_ON_ARRIVAL,
                                  sp.SCHED_ON_BATCH_DONE, sp.SCHED_ON_DECODE_STEP)):
        assert log.ns[name] == pytest.approx(res.hook_ms[hook] * 1e6, abs=log.calls[name])
    assert log.calls[sp.SCHED_NEXT_BATCH] == res.n_decisions
    nb = log.intervals(sp.SCHED_NEXT_BATCH)
    (run_lo, run_hi, _), = log.intervals(sp.LOOP_RUN)
    assert run_lo <= nb[0, 0] and nb[-1, 1] <= run_hi
    assert np.all(nb[1:, 0] >= nb[:-1, 1])  # one decision at a time
    sizes = nb[nb[:, 2] > 0, 2]
    assert len(sizes) == res.n_batches and sizes.sum() == res.n_total - res.n_dropped
    started = sorted((r.started, r.release) for r in reqs if r.started is not None)
    assert sorted(log.queue_wait_ms) == pytest.approx(sorted(s - rel for s, rel in started))
    assert min(log.queue_wait_ms) >= 0.0


def test_array_loop_refuses_a_span_log():
    rs = _trace(n=20)
    with pytest.raises(ValueError, match="array engine"):
        run_event_loop(rs.fresh(), [Worker(OrlojScheduler(LM), ModelExecutor(LM))],
                       engine="array", spans=sp.SpanLog())


# ------------------------------------------------- executor and set-up
@pytest.fixture(scope="module")
def served():
    """A tiny engine fitted and then serving a window, with one span log."""
    engine = TorchServingEngine(TINY, ECFG, device="cpu")
    log = engine.executor.spans = sp.SpanLog()
    lm = engine.profile_latency_model()
    reqs, hist = engine.make_requests(
        40, lm, length_sampler=lambda rng: int(rng.integers(4, 32)),
        slo_scale=50.0, utilization=0.5, seed=1)
    dists = {a: EmpiricalDistribution.from_samples(x) for a, x in hist.items() if len(x) >= 2}
    sched = OrlojScheduler(lm, cfg=SchedulerConfig(batch_sizes=(1, 2, 4)), initial_dists=dists)
    engine.executor.drain_measured()
    res = run_event_loop(reqs, [Worker(sched, engine.executor)], spans=log)
    return log, res, engine.executor.drain_measured()


def test_fit_holds_every_capture_and_the_window_none(served):
    log, res, measured = served
    (fit_lo, fit_hi, _), = log.intervals(sp.ENGINE_FIT)
    caps = log.intervals(sp.EXEC_CAPTURE)
    assert len(caps) == len(ECFG.buckets) * len(ECFG.batch_sizes)
    assert np.all((caps[:, 0] >= fit_lo) & (caps[:, 1] <= fit_hi))
    (run_lo, run_hi, _), = log.intervals(sp.LOOP_RUN)
    assert fit_hi <= run_lo
    assert not np.any((caps[:, 1] > run_lo) & (caps[:, 0] < run_hi))
    assert log.ns[sp.ENGINE_FIT] == fit_hi - fit_lo


def test_executor_spans_are_ordered_and_agree_with_measured(served):
    log, res, measured = served
    (run_lo, run_hi, _), = log.intervals(sp.LOOP_RUN)
    pad = log.intervals(sp.EXEC_PAD)
    h2d, replay = (x[x[:, 0] >= run_lo] for x in (log.intervals(sp.EXEC_H2D),
                                                   log.intervals(sp.EXEC_REPLAY)))
    assert len(pad) == len(h2d) == len(replay) == len(measured) == res.n_batches > 5
    assert np.all(pad[:, 0] <= pad[:, 1]) and np.all(pad[:, 1] <= h2d[:, 0])
    assert np.all(h2d[:, 0] <= h2d[:, 1]) and np.all(h2d[:, 1] <= replay[:, 0])
    assert np.all(replay[:-1, 1] <= pad[1:, 0])  # batch after batch, no overlap
    assert np.all((pad[:, 0] >= run_lo) & (replay[:, 1] <= run_hi))
    ms = np.array([m for _, _, m in measured])
    np.testing.assert_allclose((replay[:, 1] - replay[:, 0]) / 1e6, ms, rtol=0, atol=0.05)
    # the fit ran the executor directly: an h2d and a replay per run, no pad
    n_fit = len(ECFG.buckets) * len(ECFG.batch_sizes) * ECFG.profile_reps
    assert log.calls[sp.EXEC_H2D] == log.calls[sp.EXEC_REPLAY] == n_fit + res.n_batches
    assert log.calls[sp.EXEC_PAD] == res.n_batches


def test_build_all_counts_nvcc_runs(monkeypatch, tmp_path):
    class Done:
        returncode = 0

        def communicate(self):
            return "", None

    def fake_start(name):
        if name == "rmsnorm":
            return None  # already built
        tmp = tmp_path / f"{name}.tmp"
        tmp.write_text("")
        return tmp_path / f"{name}.so", tmp, Done()

    monkeypatch.setattr(_build, "_start", fake_start)
    monkeypatch.setattr(_build, "nvcc_runs", 0)
    monkeypatch.setattr(_build, "nvcc_seconds", 0.0)
    _build.build_all(("flash_attention", "rmsnorm", "moe_gating"))
    assert _build.nvcc_runs == 2 and _build.nvcc_seconds > 0.0
    _build.build_all(("rmsnorm",))
    assert _build.nvcc_runs == 2
