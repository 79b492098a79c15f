"""``device_idle`` in Hymba-1.5B's cell: the share of the traced window
that no kernel covers, the host's part of a busy card."""

from orloj_bench.harness import load_metric

read = load_metric("device_idle")
