"""The scheduler's host time per decision (us): the event loop's measured
time inside the scheduler's hooks over its ``next_batch`` calls."""


def read(run):
    n = run.sim.n_decisions
    return run.sim.sched_time_ms * 1e3 / n if n else None
