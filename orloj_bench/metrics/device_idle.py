"""The share of the traced window's wall time that no kernel covers (%),
from the device trace over the whole window."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
