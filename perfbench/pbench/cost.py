"""The yardstick of a kernel's roofline share: the card's published peaks,
and the operations and bytes the mapping k-NN needs for the inputs each
call receives, counted whatever kernel does the work.

The least time of a call is the larger of operations over the float32
peak (no tensor cores) and bytes over the memory bandwidth, each input
byte read once and each output byte written once.  The counts follow
chip_smoke.py's bound (PAIR_OPS, the windowed pairs) with live queries
only.
"""

from __future__ import annotations

import torch

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(fp32_ops_per_s=67e12,
                                  bytes_per_s=3.35e12),
}
PAIR_OPS = 9   # 3 sub, 3 mul, 2 add and 1 compare per query/point pair


def least_seconds(ops: float, n_bytes: float, card: str) -> float | None:
    """The least time the card could take; None for a card without a
    row in PEAKS."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    return max(ops / peak["fp32_ops_per_s"], n_bytes / peak["bytes_per_s"])


def windowed_knn(n_q, n_ref, k: int, t_lo, t_hi, tq: int, tm: int):
    """(operations, bytes) of one call of the windowed exact k-NN: per
    scenario, n_q (B,) live queries in blocks of tq, each block scanning
    the reference tiles [t_lo, t_hi) (B, Q / tq) of tm points, cut at the
    n_ref (B,) live references.  Reads each live query and reference
    (12 bytes) and the windows (8 bytes a block); writes k (index,
    squared distance) pairs (8 bytes) a live query."""
    n_q, n_ref = n_q.long().cpu(), n_ref.long().cpu()
    t_lo, t_hi = t_lo.long().cpu(), t_hi.long().cpu()
    blocks = t_lo.shape[-1]
    start = torch.arange(blocks) * tq
    live_q = (n_q[:, None] - start).clamp(0, tq)
    seen = (torch.minimum(t_hi * tm, n_ref[:, None])
            - t_lo.clamp(min=0) * tm).clamp(min=0)
    pairs = int((live_q * seen).sum())
    n_bytes = int((12 * (n_q + n_ref) + 8 * k * n_q).sum()) \
        + 8 * blocks * n_q.shape[0]
    return PAIR_OPS * pairs, n_bytes


def candidate_select(valid, k: int):
    """(operations, bytes) of one call of the k-of-C selection: valid
    (Q, C) live candidates; reads every candidate (12 bytes and its flag)
    and each query, writes k points and squared distances (16 bytes) a
    query."""
    Q, C = valid.shape
    pairs = int(valid.sum())
    return PAIR_OPS * pairs, Q * C * 13 + Q * 12 + Q * k * 16
