"""``sched_us_per_next_batch``: read from the program's per-hook meter, at
most the all-hook ``sched_us_per_decision``, and nothing from a program
whose loop does not meter by hook."""

import types

import pytest

from orloj_bench import harness


def _run(sim):
    return harness.Run(cell=None, sim=sim, counted=[], t_end_ms=1000.0, slo_ms=100.0,
                       batches=[], lm=None, setup_s=0.0, failed=set())


def test_reads_the_next_batch_meter():
    sim = types.SimpleNamespace(
        hook_ms={"next_batch": 3.0, "on_arrival": 5.0, "on_batch_done": 1.0, "on_decode_step": 0.0},
        hook_calls={"next_batch": 12, "on_arrival": 40, "on_batch_done": 10, "on_decode_step": 0},
        sched_time_ms=9.0, n_decisions=12)
    assert harness.load_metric("sched_us_per_next_batch")(_run(sim)) == pytest.approx(250.0)
    assert harness.load_metric("sched_us_per_decision")(_run(sim)) == pytest.approx(750.0)


@pytest.mark.parametrize("sim", [
    types.SimpleNamespace(sched_time_ms=9.0, n_decisions=12),  # a loop without the meter
    types.SimpleNamespace(hook_ms={"next_batch": 0.0}, hook_calls={"next_batch": 0}),
])
def test_nothing_without_the_meter_or_a_call(sim):
    assert harness.load_metric("sched_us_per_next_batch")(_run(sim)) is None


def test_a_program_run_reads_below_the_all_hook_mean():
    from repro_torch.core import BatchLatencyModel, ModelExecutor, OrlojScheduler, Worker
    from repro_torch.core.eventloop import run_event_loop
    from repro_torch.serving.trace import TraceConfig, generate_requests
    from repro_torch.serving.workload import bimodal

    lm = BatchLatencyModel(c0=25.0, c1=1.0)
    rs = generate_requests(bimodal(1.0), lm, slo_scale=3.0,
                           cfg=TraceConfig(n_requests=200, seed=3, utilization=0.8))
    sim = run_event_loop(rs.fresh(), [Worker(OrlojScheduler(lm, initial_dists=rs.initial_dists()),
                                             ModelExecutor(lm))], charge_scheduler_overhead=True)
    per_call = harness.load_metric("sched_us_per_next_batch")(_run(sim))
    assert per_call == pytest.approx(sim.hook_ms["next_batch"] * 1e3 / sim.hook_calls["next_batch"])
    assert 0.0 < per_call <= harness.load_metric("sched_us_per_decision")(_run(sim))
