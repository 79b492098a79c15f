"""``latency_p95_ms`` in Hymba-1.5B's cell, above capacity: recorded, not
judged."""

from orloj_bench.harness import load_metric

read = load_metric("latency_p95_ms")
