"""A whole run at a tiny size on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: each fault that a served
cell can have turns ``correct`` false.  (A cell on one chip has no exchange
between chips to leave out.)"""

import json
import time

import numpy as np
import pytest
import torch

from orloj_bench import harness, trace
from orloj_bench.tests._tiny import TINY


def _cell(kind: str):
    bench = json.loads(harness.BENCH_FILE.read_text())
    cell = harness.load_cell("glm4_9b.bimodal.r80", bench)
    cell.config = TINY[kind]
    cell.traffic = {"mix": "bimodal", "rate_rps": 60.0, "slo_ms": 200.0}
    return cell


def _run(kind="attn", traced=False):
    res, lines = harness.run_cell(_cell(kind), 2**31 + 77, 2.0, traced, torch.device("cpu"),
                                  time.perf_counter())
    return res, lines


@pytest.mark.parametrize("kind", sorted(TINY))
def test_sound_run_is_correct(kind):
    res, lines = _run(kind)
    assert res["correct"] and res["failed"] == 0, lines
    assert res["attempted"] > 50
    assert list(res)[-1] == "checks"
    assert res["checks"]["requests_compared_at_least"]["value"] >= 8
    assert set(res["metrics"]) == {"latency_p95_ms", "goodput_tok_s", "setup_s"}


def _patch_logits(monkeypatch, fn):
    from repro_torch.models import model as model_mod

    real = model_mod.Model.logits

    def broken(self, params, batch):
        return fn(real(self, params, batch))

    monkeypatch.setattr(model_mod.Model, "logits", broken)


def test_stale_state_is_caught(monkeypatch):
    """The step returns its state unchanged: every batch gets the logits of
    the first one served."""
    from repro_torch.serving import engine as eng

    real, first = eng.TorchExecutor._run, {}

    def stale(self, tokens):
        out = real(self, tokens)
        first.setdefault("logits", self.last_logits.clone())
        lg = first["logits"]
        k, s = self.last_logits.shape[:2]
        fill = torch.zeros_like(self.last_logits)
        fill[: min(k, lg.shape[0]), : min(s, lg.shape[1])] = lg[:k, :s]
        self.last_logits = fill
        return out

    monkeypatch.setattr(eng.TorchExecutor, "_run", stale)
    res, _ = _run()
    assert not res["correct"] and res["failed"] > 0


def test_half_the_batch_left_out_is_caught(monkeypatch):
    def half(lg):
        out = lg.clone()
        k = lg.shape[0]
        if k > 1:
            out[k // 2:] = lg[: k - k // 2]
        else:
            out.zero_()
        return out

    _patch_logits(monkeypatch, half)
    res, _ = _run()
    assert not res["correct"] and res["failed"] > 0


def test_an_altered_answer_is_caught(monkeypatch):
    def altered(lg):
        out = lg.clone()
        out[:, 0, 7] += 50.0  # the first position's answer of every row
        return out

    _patch_logits(monkeypatch, altered)
    res, _ = _run()
    assert not res["correct"] and res["failed"] > 0


def test_a_batch_that_raises_fails_its_requests(monkeypatch):
    from repro_torch.serving import engine as eng

    real, calls = eng.TorchExecutor.__call__, {"n": 0}

    def flaky(self, batch, now):  # served batches only: the fit calls _run
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("planted")
        return real(self, batch, now)

    monkeypatch.setattr(eng.TorchExecutor, "__call__", flaky)
    res, lines = _run()
    assert not res["correct"] and res["checks"]["requests_raised"]["value"] > 0
    assert any("planted" in line for line in lines)


class _HostRecorder:
    """The device trace's stand-in on the CPU: one kernel-less window."""

    def __init__(self):
        self.t0 = time.time_ns()

    def stop(self):
        t1 = time.time_ns()
        return trace.Trace(names=["kernel"], start_ns=np.array([self.t0]),
                           end_ns=np.array([self.t0 + 1]), window=(self.t0, t1))


@pytest.mark.parametrize("traced", [False, True])
def test_a_traced_run_carries_the_programs_span_log(traced, monkeypatch):
    """Traced: the program's span log, from the fit through the window, with
    one ``loop.run`` and one ``exec.replay`` a served batch inside it;
    untraced: none."""
    from repro_torch.core import spans as sp

    runs, real = [], harness.Run

    def kept(**kw):
        runs.append(real(**kw))
        return runs[-1]

    monkeypatch.setattr(harness, "Run", kept)
    monkeypatch.setattr(trace, "Recorder", _HostRecorder)
    res, lines = _run(traced=traced)
    assert res["correct"], lines
    (run,) = runs
    assert run.launches == {}  # the CPU captures no graph, so counts no launch
    if not traced:
        assert run.spans is None
        return
    log = run.spans
    assert isinstance(log, sp.SpanLog) and log.dropped == 0
    (lo, hi, _), = log.intervals(sp.LOOP_RUN)
    replays = log.intervals(sp.EXEC_REPLAY)
    inside = replays[(replays[:, 0] >= lo) & (replays[:, 1] <= hi)]
    assert len(inside) == len(run.batches) > 50
    assert len(log.intervals(sp.ENGINE_FIT)) == 1
    assert len(replays) > len(inside)  # the fit's replays come before the window
