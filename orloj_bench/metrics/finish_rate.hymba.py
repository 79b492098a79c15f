"""``finish_rate`` in Hymba-1.5B's cell, above capacity: recorded, not
judged (the queue grows through the window)."""

from orloj_bench.harness import load_metric

read = load_metric("finish_rate")
