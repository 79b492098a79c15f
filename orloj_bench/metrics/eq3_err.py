"""The mean relative error of the scheduler's Eq.-3 latency model over the
window's batches (%): |c0 + c1·k·l − measured| / measured, at each batch's
padded size and bucket, against the program's own measured time."""


def read(run):
    errs = [abs(run.lm.c0 + run.lm.c1 * b["k_pad"] * b["bucket"] - b["inner_ms"]) / b["inner_ms"]
            for b in run.batches if b["inner_ms"] > 0]
    return 100.0 * sum(errs) / len(errs) if errs else None
