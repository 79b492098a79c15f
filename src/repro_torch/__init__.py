"""PyTorch + CUDA port of the Orloj serving path.

The JAX package :mod:`repro` is the reference; this package mirrors its
layout module for module.  The scheduling core (``core/``), the
framework-free serving helpers (``serving/{batcher,faults,workload,
residency,trace,cluster}.py``) and the eval stack but its engine
substrate (``eval/``) are byte-identical copies.  The models, the serving
engine, the engine substrate (``eval/substrate.py``, ``eval/run.py``) and
the four kernels of the TPU package are ported: plain tensor code is
PyTorch, and the kernels are CUDA C++ written for Hopper
(``kernels/csrc/``), built with ``nvcc`` on first use.  There are nine:
the four, the backwards of flash attention, RMSNorm and the MoE gates,
the float32 GEMM of the weight products and Mamba's selective scan.

Every entry point runs on the card unless the caller passes
``device="cpu"``; without a CUDA device the default raises.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
