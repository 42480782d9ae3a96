"""IEEE-exact float32 primitives the port needs to reproduce the JAX
package's numbers.

torch's CPU sqrt (SLEEF, 0.5001 ulp) is not correctly rounded: about
0.6% of float32 inputs come back one ulp off XLA's IEEE sqrt, and the
plane fits of near-collinear neighbour sets amplify one ulp into a
visibly different normal.  And torch's vectorized sum over a short axis
groups additions differently from XLA:CPU, which reduces small axes
strictly left to right.  So does torch's cumsum (the CPU kernel
accumulates float32 in float64, the CUDA one scans in parallel) against
jnp.cumsum, which XLA:CPU rewrites into a two-level scan.  And XLA:CPU
contracts a * b + c in a fused loop into one fused multiply-add.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt: the float64 root of a float32 value rounds
    to the IEEE float32 root (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).to(x.dtype)


def fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, as XLA:CPU's contracted multiply-add, for
    float32 a and c and a Python scalar b (rounded to float32 first, as
    JAX's weak type does).  The float64 product of two float32 values is
    exact, so one float64 add and one rounding give the fused result
    (but where the float64 sum falls on a float32 halfway point, which
    the extra 29 bits make rare)."""
    b32 = float(torch.tensor(b, dtype=torch.float32))
    return (a.double() * b32 + c.double()).to(a.dtype)


def seq_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over a short axis strictly left to right."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


_SCAN_BLOCK = 16   # XLA:CPU's reduce-window rewrite of a long scan


def cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive float cumulative sum grouped as XLA:CPU groups
    jnp.cumsum: blocks of 16 elements summed left to right, the block
    totals scanned the same way recursively, and each block's running
    sums plus the total of the blocks before it.  Equal to jnp.cumsum on
    the CPU bit for bit, on any device; about 20 elementwise launches a
    level, log16(n) levels."""
    b = _SCAN_BLOCK
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    m = -(-n // b) * b
    blocks = torch.nn.functional.pad(x, (0, m - n)).reshape(
        x.shape[:-1] + (m // b, b)).clone()
    for j in range(1, b):
        blocks[..., j] += blocks[..., j - 1]
    if m > b:
        before = torch.nn.functional.pad(cumsum(blocks[..., :-1, -1], -1),
                                         (1, 0))
        blocks = blocks + before[..., None]
    return blocks.reshape(x.shape[:-1] + (m,))[..., :n].movedim(-1, dim)
