"""``gemm_roofline`` in Hymba-1.5B's cell, with the hymba family's
products: a layer that reuses its partner's K/V lists no k/v product, so
the launch-count check holds only where the program skips them."""

from orloj_bench.harness import load_metric

read = load_metric("gemm_roofline")
