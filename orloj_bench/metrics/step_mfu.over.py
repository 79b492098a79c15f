"""``step_mfu`` in a cell above capacity, where it moves the tokens done."""

from orloj_bench.harness import load_metric

read = load_metric("step_mfu")
