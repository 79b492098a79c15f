"""Counting: misses (drops, late or unresolved requests) move the finish
rate and goodput and never ``failed``; only the counted requests count."""

import types

import numpy as np
import pytest

from orloj_bench import harness

SLO = 100.0


def _req(rid, release, *, finished=None, dropped=None, n=10):
    return types.SimpleNamespace(
        rid=rid, release=release, slo=SLO, finished=finished, dropped=dropped,
        payload=np.ones(n, np.int32),
        ok=finished is not None and finished <= release + SLO)


def _sim(reqs, t_end, conserved=True):
    return types.SimpleNamespace(makespan_ms=t_end, conserved=conserved, n_total=len(reqs),
                                 n_finished_ok=0, n_finished_late=0, n_dropped=0,
                                 n_unserved=len(reqs) if conserved else 0, n_rejected=0,
                                 n_failed=0)


def _run(reqs, t_end=1000.0, wrong=frozenset(), conserved=True):
    sim = _sim(reqs, t_end, conserved)
    counted, failed, lost = harness.tally(reqs, sim, SLO, set(wrong))
    run = harness.Run(cell=None, sim=sim, counted=counted, t_end_ms=t_end,
                      slo_ms=SLO, batches=[], lm=None, setup_s=0.0, failed=failed)
    read = {m: harness.load_metric(m)(run) for m in ("finish_rate", "goodput_tok_s",
                                                      "latency_p95_ms")}
    return counted, failed, lost, read


def _base():
    return [_req(i, 100.0 * i, finished=100.0 * i + 50.0) for i in range(5)]


def test_all_met():
    counted, failed, lost, read = _run(_base())
    assert len(counted) == 5 and not failed and lost == 0
    assert read["finish_rate"] == 100.0
    assert read["goodput_tok_s"] == pytest.approx(50 / 0.9)


@pytest.mark.parametrize("miss", ["dropped", "late", "unresolved"])
def test_a_miss_moves_finish_rate_not_failed(miss):
    reqs = _base()
    r = reqs[2]
    if miss == "dropped":
        reqs[2] = _req(r.rid, r.release, dropped=r.release + 10.0)
    elif miss == "late":
        reqs[2] = _req(r.rid, r.release, finished=r.release + SLO + 1.0)
    else:
        reqs[2] = _req(r.rid, r.release)
    counted, failed, lost, read = _run(reqs)
    assert len(counted) == 5 and not failed and lost == 0
    assert read["finish_rate"] == 80.0
    assert read["goodput_tok_s"] == pytest.approx(40 / 0.9)


def test_a_late_request_keeps_its_latency_and_a_dropped_one_has_none():
    reqs = _base()
    reqs[1] = _req(1, 100.0, finished=100.0 + 3 * SLO)
    reqs[3] = _req(3, 300.0, dropped=310.0)
    _, _, _, read = _run(reqs)
    lat = [50.0, 3 * SLO, 50.0, 50.0]
    assert read["latency_p95_ms"] == pytest.approx(np.percentile(lat, 95))


def test_requests_released_after_t_end_minus_slo_are_not_counted():
    reqs = _base() + [_req(9, 950.0), _req(10, 900.0, finished=960.0)]
    counted, failed, _, read = _run(reqs, wrong={9})
    assert {r.rid for r in counted} == {0, 1, 2, 3, 4, 10}
    assert not failed  # the wrong one was not counted
    assert read["finish_rate"] == 100.0


def test_wrong_outputs_and_lost_requests_are_failures():
    counted, failed, lost, read = _run(_base(), wrong={1, 3}, conserved=False)
    assert failed == {1, 3}
    assert lost == 5
    assert read["finish_rate"] == 60.0
