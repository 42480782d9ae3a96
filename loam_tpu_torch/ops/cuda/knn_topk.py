"""Exact k-NN over live, tile-windowed reference sets: CUDA kernel
wrappers, their plain version, and the callers' helpers (counterpart of
loam_tpu/ops/pallas/knn_topk.py).

Contract (kernel and plain version): q (B, Q, 3), ref (B, M, 3) float32;
n_q, n_ref (B,) int32 live counts (both clouds front-compacted);
t_lo, t_hi (B, Q/tq) int32 reference-tile windows per query block.
Query block b (rows [b*tq, (b+1)*tq)) is live when
b < max(1, ceil(n_q/tq)); it sees reference j iff j < n_ref and
t_lo[b] <= j // tm < t_hi[b].  Returns idx (B, Q, k) int32 and
d2 (B, Q, k) float32, nearest first, ties to the smaller index, exact
fp32 distances; missing neighbours and dead blocks read (index 0,
d2 = 1e30).  Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn import BIG, pairwise_sq_dists
from . import _build

KERNEL_K = (1, 5)
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def full_windows(B, Q, M, tq, tm, device):
    nqb = Q // tq
    t_lo = torch.zeros((B, nqb), dtype=torch.int32, device=device)
    t_hi = torch.full((B, nqb), -(-M // tm), dtype=torch.int32,
                      device=device)
    return t_lo, t_hi


def knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi, *, tq, tm):
    """The contract above in plain torch: k first-occurrence argmins per
    query block over the visible references."""
    B, Q, _ = q.shape
    M = ref.shape[1]
    dev = q.device
    nqb = Q // tq
    live_blocks = torch.clamp(-(-n_q.long() // tq), 1, nqb)        # (B,)
    col = torch.arange(M, device=dev)
    tile = col // tm
    idx_out = torch.zeros((B, Q, k), dtype=torch.int32, device=dev)
    d2_out = torch.full((B, Q, k), BIG, dtype=torch.float32, device=dev)
    for blk in range(nqb):
        rows = slice(blk * tq, (blk + 1) * tq)
        vis = ((col[None] < n_ref[:, None])
               & (tile[None] >= t_lo[:, blk, None])
               & (tile[None] < t_hi[:, blk, None])
               & (blk < live_blocks)[:, None])                     # (B, M)
        d2 = pairwise_sq_dists(q[:, rows], ref)                    # (B, tq, M)
        d2 = torch.where(vis[:, None, :], d2, float("inf"))
        for s in range(k):
            i = torch.argmin(d2, dim=-1)
            d = torch.gather(d2, -1, i[..., None])[..., 0]
            found = torch.isfinite(d)
            idx_out[:, rows, s] = torch.where(found, i, 0).to(torch.int32)
            d2_out[:, rows, s] = torch.where(found, d, BIG)
            d2.scatter_(-1, i[..., None], float("inf"))
    return idx_out, d2_out


def _launch(q, ref, n_q, n_ref, k, t_lo, t_hi, tq, tm):
    B, Q, _ = q.shape
    M = ref.shape[1]
    if k not in KERNEL_K or Q % tq or tq > 1024:
        raise ValueError(f"knn kernel: unsupported k={k} tq={tq} Q={Q}")
    nqb = Q // tq
    _build.require(q, torch.float32, (B, Q, 3), "q")
    _build.require(ref, torch.float32, (B, M, 3), "ref")
    for name, t, shape in (("n_q", n_q, (B,)), ("n_ref", n_ref, (B,)),
                           ("t_lo", t_lo, (B, nqb)),
                           ("t_hi", t_hi, (B, nqb))):
        _build.require(t, torch.int32, shape, name)
    d2 = torch.empty((B, Q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, Q, k), dtype=torch.int32, device=q.device)
    launch = _build.entry("knn_topk", _ARGTYPES)
    err = launch(*(_build.ptr(t) for t in (q, ref, n_q, n_ref, t_lo, t_hi,
                                           d2, idx)),
                 B, Q, M, k, tq, tm, _build.stream_of(q))
    _build.check(err, "knn_topk")
    return idx, d2


def knn_topk(q, ref, n_ref, k: int, *, tq: int, tm: int):
    """All query blocks against the whole live reference set (the
    odometry 1-NN; Pallas _knn_kernel)."""
    B, Q, _ = q.shape
    n_q = torch.full((B,), Q, dtype=torch.int32, device=q.device)
    t_lo, t_hi = full_windows(B, Q, ref.shape[1], tq, tm, q.device)
    if q.device.type == "cpu":
        return knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                              tq=tq, tm=tm)
    out = _launch(q, ref, n_q, n_ref, k, t_lo, t_hi, tq, tm)
    knn_topk.launches += 1
    return out


knn_topk.launches = 0


def knn_topk_dyn(q, ref, n_q, n_ref, k: int, t_lo, t_hi, *, tq: int,
                 tm: int):
    """Live query blocks against their reference-tile windows (the
    mapping k-NN; Pallas _knn_kernel_dyn)."""
    if q.device.type == "cpu":
        return knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                              tq=tq, tm=tm)
    out = _launch(q, ref, n_q, n_ref, k, t_lo, t_hi, tq, tm)
    knn_topk_dyn.launches += 1
    return out


knn_topk_dyn.launches = 0


def tile(n: int, prefs) -> int:
    for t in prefs:
        if n % t == 0:
            return t
    return n


def tile_windows(qa, n_q, ra, ref_mask, tq: int, tm: int, margin: float):
    """Per-query-block reference-tile windows (loam_tpu knn_topk.py:
    389-419).  qa (Q,) / ra (M,) coordinates on the pruning axis; the
    reference is sorted ascending on it over its live prefix.  Returns
    (t_lo, t_hi) int32 (Q/tq,)."""
    big = 3.0e38
    Q, M = qa.shape[0], ra.shape[0]
    live_q = torch.arange(Q, device=qa.device) < n_q
    qb = torch.where(live_q, qa, big).reshape(Q // tq, tq)
    qlo = qb.min(1).values - margin
    qhi = torch.where(qb >= big, -big, qb).max(1).values + margin
    rt = torch.where(ref_mask, ra, big).reshape(-1, tm)
    tmin = rt.min(1).values
    tmax = torch.where(rt >= big, -big, rt).max(1).values
    tmax = torch.where(tmax <= -big, big, tmax)
    t_lo = (tmax[None, :] < qlo[:, None]).sum(1, dtype=torch.int32)
    t_hi = M // tm - (tmin[None, :] > qhi[:, None]).sum(1, dtype=torch.int32)
    return t_lo, t_hi.to(torch.int32)


def recenter(q_xyz, ref_xyz, ref_mask):
    """Queries and references relative to the live references' mean,
    each (1, n, 3) for the kernels, and the live count (int32 ()).  Keeps
    cancellation out of distances far from the origin."""
    n_live = ref_mask.sum(dtype=torch.int32)
    center = torch.where(ref_mask[:, None], ref_xyz, 0.0).sum(0) / \
        torch.clamp(n_live.to(torch.float32), min=1.0)
    return ((q_xyz - center)[None].contiguous(),
            (ref_xyz - center)[None].contiguous(), n_live)


def knn_points(q_xyz, ref_xyz, ref_mask, k: int = 5, n_q=None,
               prune_axis=None, prune_window: float | None = None):
    """k nearest live references per query.  Returns (pts (Q, k, 3),
    d2 (Q, k)) nearest-first, d2 = 1e30 where a neighbour is missing.
    ref must be front-compacted.  With n_q (live queries, also
    front-compacted), prune_axis (the axis the reference is sorted on,
    a 0-dim tensor) and prune_window (the caller's gate radius), query
    blocks only visit reference tiles within the window on that axis:
    exact for every neighbour inside the gate (loam_tpu knn_points)."""
    Q, M = q_xyz.shape[0], ref_xyz.shape[0]
    dev = q_xyz.device
    qc, rc, n_live = recenter(q_xyz, ref_xyz, ref_mask)
    tq = tile(Q, (256, 128, 64, 32, 16, 8))
    tm = tile(M, (512, 256, 128))
    n_ref = n_live.reshape(1)
    if n_q is None:
        idx, d2k = knn_topk(qc, rc, n_ref, k, tq=tq, tm=tm)
    else:
        if prune_axis is not None and prune_window is not None:
            axis = prune_axis.reshape(1).long()
            qa = qc[0].index_select(1, axis)[:, 0]
            ra = rc[0].index_select(1, axis)[:, 0]
            # +1 mm absolute slack for the recentring rounding
            t_lo, t_hi = tile_windows(qa, n_q, ra, ref_mask, tq, tm,
                                      float(prune_window) + 1e-3)
            t_lo, t_hi = t_lo[None], t_hi[None]
        else:
            t_lo, t_hi = full_windows(1, Q, M, tq, tm, dev)
        idx, d2k = knn_topk_dyn(
            qc, rc, n_q.to(torch.int32).reshape(1), n_ref, k,
            t_lo.contiguous(), t_hi.contiguous(), tq=tq, tm=tm,
        )
    idx, invalid = idx[0].long(), d2k[0] > 1e28
    pts = ref_xyz[idx.clamp(0, M - 1)]
    # exact distances in the caller's frame, nearest first
    diff = q_xyz[:, None, :] - pts
    d2 = torch.where(invalid, BIG, (diff * diff).sum(-1))
    order = torch.argsort(d2, dim=1, stable=True)
    return (torch.gather(pts, 1, order[..., None].expand(pts.shape)),
            torch.gather(d2, 1, order))
