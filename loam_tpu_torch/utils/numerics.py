"""IEEE-exact float32 primitives the port needs to reproduce the JAX
package's numbers.

torch's CPU sqrt (SLEEF, 0.5001 ulp) is not correctly rounded: about
0.6% of float32 inputs come back one ulp off XLA's IEEE sqrt, and the
plane fits of near-collinear neighbour sets amplify one ulp into a
visibly different normal.  And torch's vectorized sum over a short axis
groups additions differently from XLA:CPU, which reduces small axes
strictly left to right.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt: the float64 root of a float32 value rounds
    to the IEEE float32 root (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).to(x.dtype)


def seq_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over a short axis strictly left to right."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc
