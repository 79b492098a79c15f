"""The Mamba scans' share of their roofline over the traced window (%): the
least time of every layer's scan in every served padded batch (the
family's ``scan_bound_s``: the convolved input, Δ, the gate's input, B and
C read once and y written once, at 3.35 TB/s) over the device time of the
kernels whose name holds ``selective_scan``.

The bound counts one scan a layer and the device time every scan kernel:
the two cover the same work only where each served shape's graph counts
one ``selective_scan`` launch a layer (``Run.launches``, the program's
counter).  Where a shape's count differs, the program kept none, or the
family has no scan, the share is not read."""

import sys
from collections import Counter

from orloj_bench import families


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    bound = getattr(families.of(cfg), "scan_bound_s", None)
    secs = sum(dur for name, dur in run.trace.seconds_by_name().items()
               if "selective_scan" in name.lower())
    if bound is None or secs <= 0:
        return None
    shapes = Counter((b["k_pad"], b["bucket"]) for b in run.batches)
    for k, s in shapes:
        launched = run.launches.get((k, s), {}).get("selective_scan")
        if launched != cfg["n_layers"]:
            print(f"ssm_scan_roofline: the ({k}, {s}) graph counts {launched} scan launches "
                  f"for {cfg['n_layers']} layers; not read", file=sys.stderr)
            return None
    return 100.0 * sum(n * bound(cfg, k, s) for (k, s), n in shapes.items()) / secs
