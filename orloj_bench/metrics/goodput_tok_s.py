"""Prompt tokens (unpadded) of the counted requests that finished within
their SLO, per second of the counted span ``T_end − slo``."""


def read(run):
    span_s = (run.t_end_ms - run.slo_ms) / 1e3
    if span_s <= 0:
        return None
    tokens = sum(len(r.payload) for r in run.counted if r.ok and r.rid not in run.failed)
    return tokens / span_s
