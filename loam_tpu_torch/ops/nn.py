"""Exact brute-force distances (counterpart of loam_tpu/ops/nn.py).

The JAX package forms |q|^2 - 2 q.r + |r|^2 so the cross term lands on
the TPU's matrix unit.  The port's kernels compute (q - r)^2 directly
on CUDA cores, and the plain versions here use the identical IEEE
sequence round(round(dx^2 + dy^2) + dz^2), so kernel and plain version
agree bit for bit, ties included.
"""

from __future__ import annotations

import torch

BIG = 1e30


def pairwise_sq_dists(q, r):
    """(..., Q, M) exact squared distances between q (..., Q, 3) and
    r (..., M, 3)."""
    d = q[..., :, None, 0] - r[..., None, :, 0]
    out = d * d
    d = q[..., :, None, 1] - r[..., None, :, 1]
    out = out + d * d
    d = q[..., :, None, 2] - r[..., None, :, 2]
    return out + d * d


def masked_argmin(d2, cand):
    """First-occurrence argmin of d2 over candidates (ties -> smallest
    index).  Returns (idx, dmin) with idx = -1 and dmin = BIG where no
    candidate exists."""
    d2m = torch.where(cand, d2, float("inf"))
    idx = torch.argmin(d2m, dim=-1)
    dmin = torch.gather(d2m, -1, idx[..., None])[..., 0]
    found = torch.isfinite(dmin)
    return (torch.where(found, idx, -1).to(torch.int32),
            torch.where(found, dmin, BIG))
