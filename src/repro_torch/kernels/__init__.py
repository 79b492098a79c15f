"""Hand-written Hopper kernels of the serving path.

Each kernel ships:
- ``csrc/<name>.cu`` — the CUDA C++ kernel for ``sm_90a`` with a plain C
  entry point, built by :mod:`._build` with ``nvcc`` on first use;
- ``<name>.py`` — the ctypes binding: input checks, output allocation,
  the launch on PyTorch's current stream, and a count of launches;
- ``ref.py`` — the plain PyTorch version of the same function;
- ``ops.py`` — the public wrappers: CPU tensors take the plain version,
  CUDA tensors the kernel.

The kernels: ``flash_attention``, ``decode_attention``, ``rmsnorm`` and
``moe_gating``.  The wrappers are not re-exported here, so that
``kernels.<name>`` stays the binding module; call them as
``kernels.ops.<name>``.
"""
