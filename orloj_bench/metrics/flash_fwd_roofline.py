"""The flash-attention forward's share of its roofline over the traced
window (%): the least time of every attention layer in every served
padded batch (``work.flash_bound_s``, by the configuration's family: FLOPs
once at 495 TFLOP/s, bytes once at 3.35 TB/s, each layer in its own
window) over the device time of the attention kernels in the trace.
An attention kernel is one whose name holds a word of ``NAMES``, matched
without case, so that a kernel that replaces this one stays readable."""

from orloj_bench import work

NAMES = ("flash", "attention", "attn", "fmha", "sdpa")


def read(run):
    if run.trace is None:
        return None
    secs = sum(dur for name, dur in run.trace.seconds_by_name().items()
               if any(n in name.lower() for n in NAMES))
    if secs <= 0:
        return None
    cfg = run.cell.config
    bound = sum(work.flash_bound_s(cfg, b["k_pad"], b["bucket"]) for b in run.batches)
    return 100.0 * bound / secs
