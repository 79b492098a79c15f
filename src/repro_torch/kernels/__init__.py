"""Hand-written Hopper kernels of the serving path.

Each kernel ships:
- ``csrc/<name>.cu`` — the CUDA C++ kernel for ``sm_90a`` with a plain C
  entry point, built by :mod:`._build` with ``nvcc`` on first use;
- ``<name>.py`` — the ctypes binding: input checks, output allocation,
  the launch on PyTorch's current stream, and a count of launches;
- ``ref.py`` — the plain PyTorch version of the same function;
- ``ops.py`` — the kernels as ``torch.library`` operators (CUDA
  implementation, fake implementation, autograd and FLOP formulas,
  DTensor sharding rules) and the public wrappers: CPU tensors take the
  plain version, CUDA (and meta) tensors the operator.

The nine kernels (``_build.KERNELS``): the four of the TPU package,
``flash_attention``, ``decode_attention``, ``rmsnorm`` and ``moe_gating``;
the backwards of the three that training differentiates through,
``flash_attention_bwd``, ``rmsnorm_bwd`` and ``moe_gating_bwd``; and two
with no TPU counterpart, ``gemm`` (the float32 weight products) and
``selective_scan`` (Mamba's scan).  The wrappers are not re-exported
here, so that ``kernels.<name>`` stays the binding module; call them as
``kernels.ops.<name>``.
"""
