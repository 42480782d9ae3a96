"""Masked stable compaction (counterpart of loam_tpu/ops/compact.py).

The JAX package sorts the payload columns along with the ~mask key in one
multi-operand lax.sort; here one stable argsort of the key plus a gather
per payload gives the identical order.
"""

from __future__ import annotations

import torch


def compact_masked(mask, payloads, cap: int):
    """Stably compact `payloads` (tuple of (..., N) tensors) under
    `mask` (..., N) into capacity `cap`.  Returns (tuple of (..., cap)
    tensors, ok (..., cap) bool); slots past the masked count hold
    residue that callers gate on `ok`."""
    n = mask.shape[-1]
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    total = mask.sum(-1, dtype=torch.int32)
    ok = torch.arange(cap, device=mask.device) < total[..., None]

    def cut(p):
        o = torch.gather(p, -1, order)
        if cap <= n:
            return o[..., :cap]
        pad = o.new_zeros(o.shape[:-1] + (cap - n,))
        return torch.cat([o, pad], -1)

    return tuple(cut(p) for p in payloads), ok
