"""Arithmetic rounded the way the JAX reference rounds it.

fma32: XLA's CPU backend contracts `a*b + c` in fused elementwise code into
one fused multiply-add (LLVM folds the FIRST product operand of an add),
so the JAX reference rounds such expressions once.  Where the port must
match it bit for bit (the CLAHE LUT blends, the 3x3 color contractions) it
computes the FMA exactly: a*b of two float32 values is exact in float64,
so round_f32(f64(a) * f64(b) + f64(c)) rounds the float64 sum and then to
float32.  That differs from a true FMA only when the float64 sum lands
exactly on a float32 rounding midpoint (a double rounding, about 2^-29 of
random inputs).  The CUDA kernels use the same float64 formula, so they
equal these plain versions bit for bit.

divide: PyTorch's CUDA division by a Python (CPU) scalar multiplies by the
scalar's reciprocal, which is not correctly rounded (x / 255 then differs
from numpy for some of the 256 u8 values).  Dividing by a 0-dim tensor on
the same device is IEEE division on both devices.
"""

import torch


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """round_f32(a*b + c) with a*b unrounded; a, b, c float32 (b and c
    may be 0-dim)."""
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float32, device=a.device)
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device (x float32)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)
