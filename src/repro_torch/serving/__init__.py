"""Serving substrate of the port: the padded-batch batcher and the fault
tier (byte-identical copies of the reference), and the real-execution
engine that couples the ORLOJ scheduler to the PyTorch model."""

from .faults import FaultPlan, FaultState, finish_probability

__all__ = ["FaultPlan", "FaultState", "finish_probability"]
