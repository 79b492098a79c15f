"""``step_mfu`` in Hymba-1.5B's cell, above capacity, where it moves the
tokens done: the family's ``batch_flops`` (products, the tied head,
attention and the scans) over the program's summed batch time, at the
float32 configuration's peak."""

from orloj_bench.harness import load_metric

read = load_metric("step_mfu")
