"""PyTorch + CUDA port of the Orloj serving path.

The JAX package :mod:`repro` is the reference; this package mirrors its
layout module for module.  The scheduling core (``core/``) and the
framework-free serving helpers (``serving/batcher.py``,
``serving/faults.py``) are byte-identical copies.  The model, the serving
engine and the two attention kernels of the serving path are ported:
plain tensor code is PyTorch, and the kernels are CUDA C++ written for
Hopper (``kernels/csrc/``), built with ``nvcc`` on first use.

Every entry point runs on the card unless the caller passes
``device="cpu"``; without a CUDA device the default raises.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
