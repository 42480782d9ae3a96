"""The reference's matrix products in float64, or as a card's TF32 mode
computes them: each operand rounded to TF32's 10 mantissa bits, the sum
in float32.  The TF32 form is the benchmark's control: the reference
one precision below the float32 with TF32 off that the port pins
(loam_tpu_torch.configure_numerics)."""

from __future__ import annotations

import numpy as np


def to_tf32(x) -> np.ndarray:
    """Float32 values rounded to the nearest TF32 value (ties to even):
    the low 13 of float32's 23 mantissa bits cleared.  Finite inputs."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    lsb = (bits >> np.uint32(13)) & np.uint32(1)
    rounded = (bits + np.uint32(0x0FFF) + lsb) & np.uint32(0xFFFFE000)
    return rounded.view(np.float32)


def product(a, b, tf32: bool) -> np.ndarray:
    """a @ b; with tf32 the TF32 product, returned in float64."""
    if not tf32:
        return a @ b
    return (to_tf32(a) @ to_tf32(b)).astype(np.float64)


def einsum(spec: str, a, b, tf32: bool) -> np.ndarray:
    """np.einsum(spec, a, b); with tf32 the TF32 contraction."""
    if not tf32:
        return np.einsum(spec, a, b)
    return np.einsum(spec, to_tf32(a), to_tf32(b)).astype(np.float64)
