"""The weight products' share of their roofline over the traced window (%):
the least time of every weight product of every served padded batch
(``work.gemm_bound_s``, by the configuration's family and dtype: FLOPs once
at the dtype's peak, both inputs read and the output written once at 3.35
TB/s) over the device time of the kernels whose name holds ``gemm``,
matched without case (the program's ``gemm_kernel`` and its split-K
``gemm_reduce_kernel``, or a library's GEMM in their place).  The bound is
the work itself, whatever splits or passes the kernel makes of it.

The bound counts every product the family lists, and the device time
every GEMM kernel: the two cover the same work only where each served
shape's graph counts one GEMM launch a product (``Run.launches``, the
program's counter).  Where a shape's count differs, or the program kept
none, the share is not read."""

import sys
from collections import Counter

from orloj_bench import work


def read(run):
    if run.trace is None:
        return None
    secs = sum(dur for name, dur in run.trace.seconds_by_name().items() if "gemm" in name.lower())
    if secs <= 0:
        return None
    cfg = run.cell.config
    shapes = Counter((b["k_pad"], b["bucket"]) for b in run.batches)
    for k, s in shapes:
        launched = run.launches.get((k, s), {}).get("gemm")
        listed = len(work.gemm_products(cfg, k, s))
        if launched != listed:
            print(f"gemm_roofline: the ({k}, {s}) graph counts {launched} GEMM launches, "
                  f"the family lists {listed} products; not read", file=sys.stderr)
            return None
    return 100.0 * sum(n * work.gemm_bound_s(cfg, k, s) for (k, s), n in shapes.items()) / secs
