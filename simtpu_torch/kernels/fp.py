"""Exact single-rounding fused multiply-add on f32 tensors.

XLA's CPU backend lets LLVM contract `a * b + c` into one FMA inside a
fusion (measured: `jax.jit(lambda a, b, c: a * b + c)` differs from the
two-rounding numpy result on ~23% of random f32 lanes). The JAX package's
reference results therefore carry an FMA at the sites that contract in its
compiled step: the resource-fit slack (`free + eps * max(|free|, 1)`),
SelectorSpread's zone blend, the Simon numerator, the static score pair,
the running score sum's later terms (kernels/scores.py) and the Open-Local
raw score's device term (kernels/storage.py). The CUDA kernels use
`__fmaf_rn` there; this is the same operation in plain PyTorch, on any
device.

Method: the product of two f32 values is exact in f64; the f64 sum is
rounded to odd (TwoSum gives its exact error) and then to f32, which gives
the correctly rounded f32 result because f64 carries more than 24 + 2 bits.
"""

from __future__ import annotations

import torch


def fma(a, b, c) -> torch.Tensor:
    """round_f32(a * b + c) with one rounding; broadcasts like `a * b + c`."""
    a64 = torch.as_tensor(a, dtype=torch.float32).double()
    b64 = torch.as_tensor(b, dtype=torch.float32).double()
    c64 = torch.as_tensor(c, dtype=torch.float32).double()
    p = a64 * b64  # exact: 24 + 24 significant bits fit in 53
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)  # s + err == p + c exactly
    bits = s.view(torch.int64)
    # round to odd: an inexact sum with an even last bit steps one ulp
    # towards the exact value (away from zero when err has s's sign)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    bits = torch.where(odd, bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)
