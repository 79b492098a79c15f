"""The tensor-core arithmetic of the port's kernels, emulated in plain torch.

The CUDA kernels compute float32 products on the tensor cores.  In TF32
(10 mantissa bits) an operand x is split into big = tf32(x) and small =
tf32(x - big), and a product keeps the terms its operands need:
big·big + big·small + small·big where both are float32 (three passes),
small·big + big·big where only A is (two passes), or big·big alone (one
pass).  In bf16 (the decode kernel over a bf16 cache, whose values are
bf16 already) the float32 operand is split into bf16 parts, each the
nearest bf16 to what the ones before it leave, and a product is the sum
of the parts' products.  The tests hold these emulations to the JAX
reference.
"""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, keeping 10 mantissa bits (integer ops on the bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands and float32 sums: one pass (big·big), two
    (small·big + big·big: A split, B taken as TF32) or three (small·big +
    big·small + big·big)."""
    a_big, b_big = tf32(a), tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small = tf32(a - a_big)
    if passes == 2:
        return a_small @ b_big + a_big @ b_big
    b_small = tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def bf16_parts(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """x as the sum of ``parts`` bf16 values (held in float32), the largest
    first: 8 significant bits a part."""
    out, rest = [], x.float()
    for _ in range(parts):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def bf16_split_matmul(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b with a split into ``parts`` bf16 parts and b taken as it is (its
    values bf16 already), float32 sums, the smallest part's product first."""
    return sum(p @ b for p in reversed(bf16_parts(a, parts)))
