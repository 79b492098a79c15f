"""The plain float32 reference of the benchmark's configurations."""

from .model import logits

__all__ = ["logits"]
