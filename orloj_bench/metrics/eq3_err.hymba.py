"""``eq3_err`` in Hymba-1.5B's cell, above capacity: the Eq.-3 fit over a
cost curve that grows about linearly past the 1024-token window (the scan,
29 windowed layers), at lengths no GLM-4-9B cell serves."""

from orloj_bench.harness import load_metric

read = load_metric("eq3_err")
