"""From the process's start to the window's first arrival (s): imports, the
weights, the engine, the Eq.-3 fit with every served shape warmed and
captured (and built, in a checkout's first run), the scheduler and the
arrivals."""


def read(run):
    return run.setup_s
