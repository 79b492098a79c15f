"""The served steps' share of the card's peak (%): ``work.batch_flops`` of
every padded batch of the window, over the program's summed measured batch
time, against 495 TFLOP/s (H100 SXM, dense TF32; the configurations
compute in float32, so work counted once against this rate stays below
100% for any correct route)."""

from orloj_bench import work


def read(run):
    secs = sum(b["inner_ms"] for b in run.batches) / 1e3
    if secs <= 0:
        return None
    flops = sum(work.batch_flops(run.cell.config, b["k_pad"], b["bucket"]) for b in run.batches)
    return 100.0 * flops / secs / work.TF32_FLOP_PER_S
