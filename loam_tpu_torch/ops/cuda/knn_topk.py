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
d2 = 1e30).  Any 1 <= k <= MAX_K: the kernel (csrc/knn_topk.cu) keeps
a sorted list of k pairs a lane in registers up to k = 8, and past it
one queue of W >= k pairs for the whole warp, spread over the lanes'
registers (W a power of two from 32, its first k pairs stored).  Each
wrapper counts its kernel launches in ``.launches``, and knn_topk_dyn's
also in ``.by_k`` by the instance the C entry reports it launched (k of
the per-lane lists, W of the warp queue).

``knn_topk`` is the special case of every query against the whole live
reference.  At k = 1 on the card it runs a kernel of its own
(csrc/knn_nearest.cu), which splits the reference range across blocks,
takes n_ref only and returns idx and d2 as strided views of one packed
(B, Q) int64 key tensor.  Squared distances at or above 1e30 are outside
the contract (the clouds are metres around their mean): that kernel
reads such a reference as a missing neighbour.
"""

from __future__ import annotations

import ctypes

import torch

from ...types import per_scenario
from ..nn import BIG, pairwise_sq_dists
from . import _build

# the largest k of csrc/knn_topk.cu (knn_topk_max_k): its widest warp
# queue, 32 (d2, index) pairs in each lane's registers; here for the
# configuration check, which runs without the library
MAX_K = 1024
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6
             + (ctypes.POINTER(ctypes.c_int), ctypes.c_void_p))
_NEAREST_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3
                     + (ctypes.c_void_p,))
# knn_nearest's key for "no reference": float32 1e30's bits above index 0
EMPTY_KEY = 0x7149F2CA << 32


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
    if not 1 <= k <= MAX_K or tq < 1 or Q % tq or tm < 1:
        raise ValueError(f"knn kernel: unsupported k={k} tq={tq} tm={tm} "
                         f"Q={Q} (k from 1 to {MAX_K}, Q a multiple of tq)")
    nqb = Q // tq
    _build.require(q, torch.float32, (B, Q, 3), "q")
    _build.require(ref, torch.float32, (B, M, 3), "ref")
    for name, t, shape in (("n_q", n_q, (B,)), ("n_ref", n_ref, (B,)),
                           ("t_lo", t_lo, (B, nqb)),
                           ("t_hi", t_hi, (B, nqb))):
        _build.require(t, torch.int32, shape, name)
    d2 = torch.empty((B, Q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, Q, k), dtype=torch.int32, device=q.device)
    instance = ctypes.c_int(0)
    launch = _build.entry("knn_topk", _ARGTYPES)
    err = launch(*(_build.ptr(t) for t in (q, ref, n_q, n_ref, t_lo, t_hi,
                                           d2, idx)),
                 B, Q, M, k, tq, tm, ctypes.byref(instance),
                 _build.stream_of(q))
    _build.check(err, "knn_topk")
    return idx, d2, instance.value


def _launch_nearest(q, ref, n_ref):
    B, Q, _ = q.shape
    M = ref.shape[1]
    _build.require(q, torch.float32, (B, Q, 3), "q")
    _build.require(ref, torch.float32, (B, M, 3), "ref")
    _build.require(n_ref, torch.int32, (B,), "n_ref")
    keys = torch.full((B, Q), EMPTY_KEY, dtype=torch.int64, device=q.device)
    launch = _build.entry("knn_nearest", _NEAREST_ARGTYPES)
    err = launch(*(_build.ptr(t) for t in (q, ref, n_ref, keys)),
                 B, Q, M, _build.stream_of(q))
    _build.check(err, "knn_nearest")
    # little-endian words of a key: index below, distance bits above
    words = keys.view(torch.int32).view(B, Q, 2)
    return words[..., :1], words.view(torch.float32)[..., 1:]


def knn_topk(q, ref, n_ref, k: int, *, tq: int, tm: int):
    """All query blocks against the whole live reference set (the
    odometry 1-NN; Pallas _knn_kernel).  tq and tm tile the plain
    version and the k > 1 kernel; the k=1 kernel picks its own blocks."""
    if q.device.type != "cpu" and k == 1:
        out = _launch_nearest(q, ref, n_ref)
        knn_topk.launches += 1
        return out
    B, Q, _ = q.shape
    n_q = torch.full((B,), Q, dtype=torch.int32, device=q.device)
    t_lo, t_hi = full_windows(B, Q, ref.shape[1], tq, tm, q.device)
    if q.device.type == "cpu":
        return knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                              tq=tq, tm=tm)
    idx, d2, _ = _launch(q, ref, n_q, n_ref, k, t_lo, t_hi, tq, tm)
    knn_topk.launches += 1
    return idx, d2


knn_topk.launches = 0


def knn_topk_dyn(q, ref, n_q, n_ref, k: int, t_lo, t_hi, *, tq: int,
                 tm: int):
    """Live query blocks against their reference-tile windows (the
    mapping k-NN; Pallas _knn_kernel_dyn)."""
    if q.device.type == "cpu":
        return knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                              tq=tq, tm=tm)
    idx, d2, K = _launch(q, ref, n_q, n_ref, k, t_lo, t_hi, tq, tm)
    knn_topk_dyn.launches += 1
    knn_topk_dyn.by_k[K] = knn_topk_dyn.by_k.get(K, 0) + 1
    return idx, d2


knn_topk_dyn.launches = 0
knn_topk_dyn.by_k = {}   # launches by the instance the C entry reports


def tile(n: int, prefs) -> int:
    for t in prefs:
        if n % t == 0:
            return t
    return n


def tile_windows(qa, n_q, ra, ref_mask, tq: int, tm: int, margin: float):
    """Per-query-block reference-tile windows (loam_tpu knn_topk.py:
    389-419).  qa (..., Q) / ra (..., M) coordinates on the pruning
    axis, n_q (...) live queries; each reference is sorted ascending on
    it over its live prefix.  Returns (t_lo, t_hi) int32 (..., Q/tq)."""
    big = 3.0e38
    Q, M = qa.shape[-1], ra.shape[-1]
    lead = qa.shape[:-1]
    live_q = torch.arange(Q, device=qa.device) < n_q[..., None]
    qb = torch.where(live_q, qa, big).reshape(lead + (Q // tq, tq))
    qlo = qb.min(-1).values - margin
    qhi = torch.where(qb >= big, -big, qb).max(-1).values + margin
    rt = torch.where(ref_mask, ra, big).reshape(lead + (-1, tm))
    tmin = rt.min(-1).values
    tmax = torch.where(rt >= big, -big, rt).max(-1).values
    tmax = torch.where(tmax <= -big, big, tmax)
    t_lo = (tmax[..., None, :] < qlo[..., :, None]).sum(-1, dtype=torch.int32)
    t_hi = M // tm - (tmin[..., None, :] > qhi[..., :, None]).sum(
        -1, dtype=torch.int32)
    return t_lo, t_hi.to(torch.int32)


def recenter(q_xyz, ref_xyz, ref_mask):
    """Queries (B, Q, 3) and references (B, M, 3) relative to each
    scenario's live-reference mean, contiguous for the kernels, and the
    live counts (B,) int32.  Keeps cancellation out of distances far
    from the origin.  Each scenario's sum is its own reduction
    (types.per_scenario)."""
    n_live = ref_mask.sum(-1, dtype=torch.int32)
    total = per_scenario(
        lambda r, m: torch.where(m[:, None], r, 0.0).sum(0), ref_xyz,
        ref_mask)
    center = total / torch.clamp(n_live.to(torch.float32), min=1.0)[:, None]
    center = center[:, None, :]
    return ((q_xyz - center).contiguous(), (ref_xyz - center).contiguous(),
            n_live)


def take_points(xyz, idx):
    """xyz (B, M, 3) at indices idx (B, ...) into the point axis."""
    B = xyz.shape[0]
    flat = idx.reshape(B, -1)
    out = torch.gather(xyz, 1, flat[..., None].expand(B, flat.shape[1], 3))
    return out.reshape(idx.shape + (3,))


def knn_points(q_xyz, ref_xyz, ref_mask, k: int = 5, n_q=None,
               prune_axis=None, prune_window: float | None = None):
    """k nearest live references per query, per scenario: q_xyz
    (B, Q, 3), ref_xyz (B, M, 3), ref_mask (B, M).  Returns
    (pts (B, Q, k, 3), d2 (B, Q, k)) nearest-first, d2 = 1e30 where a
    neighbour is missing.  ref must be front-compacted.  With n_q (B,)
    (live queries, also front-compacted), prune_axis (B,) (the axis
    each reference is sorted on) and prune_window (the caller's gate
    radius), query blocks only visit reference tiles within the window
    on that axis: exact for every neighbour inside the gate (loam_tpu
    knn_points)."""
    B, Q, _ = q_xyz.shape
    M = ref_xyz.shape[1]
    dev = q_xyz.device
    qc, rc, n_live = recenter(q_xyz, ref_xyz, ref_mask)
    tq = tile(Q, (256, 128, 64, 32, 16, 8))
    tm = tile(M, (512, 256, 128))
    if n_q is None:
        idx, d2k = knn_topk(qc, rc, n_live, k, tq=tq, tm=tm)
    else:
        if prune_axis is not None and prune_window is not None:
            axis = prune_axis.long()
            qa = torch.gather(qc, 2, axis[:, None, None].expand(B, Q, 1))
            ra = torch.gather(rc, 2, axis[:, None, None].expand(B, M, 1))
            # +1 mm absolute slack for the recentring rounding
            t_lo, t_hi = tile_windows(qa[..., 0], n_q, ra[..., 0], ref_mask,
                                      tq, tm, float(prune_window) + 1e-3)
        else:
            t_lo, t_hi = full_windows(B, Q, M, tq, tm, dev)
        idx, d2k = knn_topk_dyn(
            qc, rc, n_q.to(torch.int32), n_live, k,
            t_lo.contiguous(), t_hi.contiguous(), tq=tq, tm=tm,
        )
    idx, invalid = idx.long(), d2k > 1e28
    pts = take_points(ref_xyz, idx.clamp(0, M - 1))
    # exact distances in the caller's frame, nearest first
    diff = q_xyz[..., None, :] - pts
    d2 = torch.where(invalid, BIG, (diff * diff).sum(-1))
    order = torch.argsort(d2, dim=-1, stable=True)
    return (torch.gather(pts, -2, order[..., None].expand(pts.shape)),
            torch.gather(d2, -1, order))
