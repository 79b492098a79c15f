"""Serving substrate of the port: workloads, traces, the padded-batch
batcher, replica-pool dispatch, the fault tier and weights residency
(byte-identical copies of the reference), and the real-execution engine
that couples the ORLOJ scheduler to the PyTorch model."""

from .faults import FaultPlan, FaultState, finish_probability

__all__ = ["FaultPlan", "FaultState", "finish_probability"]
