"""Odometry correspondence search: the ring-walk CUDA kernel wrapper, its
plain version, and odom_correspondences (counterpart of
loam_tpu/ops/pallas/odom_corr.py).

Contract of ``odom_corr`` (kernel and plain version): q (B, Q, 3),
ref (B, M, 3) float32; ring (B, M) int32; j1 (B, Q) int32 gated 1-NN
(-1 none); n_q, n_ref (B,) int32.  Returns (j2, j3, d2, d3): the best
2nd / 3rd point per query (int32, -1 none) and their exact squared
distances (1e30 none), under the walk rules documented in
csrc/odom_corr.cu; ties go to the smaller index.  The wrapper counts
its kernel launches in ``odom_corr.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn import BIG, masked_argmin, pairwise_sq_dists
from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 3 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
from .knn_topk import knn_topk, recenter, tile


def odom_corr_plain(q, ref, ring, j1, n_q, n_ref, *, surf: bool,
                    window: float, truncate: bool):
    """The walk rules as (B, Q, M) masks: break positions, then a
    first-occurrence argmin over the eligible columns."""
    B, Q, _ = q.shape
    M = ref.shape[1]
    col = torch.arange(M, device=q.device)[None, None, :]
    ring_f = ring.to(torch.float32)[:, None, :]                   # (B, 1, M)
    has1 = (j1 >= 0)[..., None]
    j1c = j1.clamp(min=0).long()
    cr = torch.gather(ring.to(torch.float32), 1, j1c)[..., None]  # (B, Q, 1)
    jq = j1[..., None]
    above = (col > jq) & (ring_f > cr + window)
    brk_up = torch.where(above.any(-1, keepdim=True),
                         torch.argmax(above.to(torch.int8), -1, keepdim=True),
                         M)
    below = (col < jq) & (ring_f < cr - window)
    brk_dn = torch.where(below, col, -1).amax(-1, keepdim=True)
    live = col < n_ref[:, None, None]
    up = (col > jq) & (col < brk_up) & live & has1
    if truncate:
        up = up & (col < n_q[:, None, None])
    dn = (col < jq) & (col > brk_dn) & live & has1
    d2 = pairwise_sq_dists(q, ref)
    if surf:
        el2 = (up & (ring_f <= cr)) | (dn & (ring_f >= cr))
        el3 = (up & (ring_f > cr)) | (dn & (ring_f < cr))
    else:
        el2 = (up & (ring_f > cr)) | (dn & (ring_f < cr))
        el3 = torch.zeros_like(el2)
    j2, dd2 = masked_argmin(d2, el2)
    j3, dd3 = masked_argmin(d2, el3)
    return j2, j3, dd2, dd3


def odom_corr(q, ref, ring, j1, n_q, n_ref, *, surf: bool, window: float,
              truncate: bool):
    """2nd/3rd correspondence points: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    kw = dict(surf=surf, window=window, truncate=truncate)
    if q.device.type == "cpu":
        return odom_corr_plain(q, ref, ring, j1, n_q, n_ref, **kw)
    out = _launch(q, ref, ring, j1, n_q, n_ref, **kw)
    odom_corr.launches += 1
    return out


odom_corr.launches = 0


def _launch(q, ref, ring, j1, n_q, n_ref, *, surf, window, truncate):
    B, Q, _ = q.shape
    M = ref.shape[1]
    _build.require(q, torch.float32, (B, Q, 3), "q")
    _build.require(ref, torch.float32, (B, M, 3), "ref")
    _build.require(ring, torch.int32, (B, M), "ring")
    _build.require(j1, torch.int32, (B, Q), "j1")
    _build.require(n_q, torch.int32, (B,), "n_q")
    _build.require(n_ref, torch.int32, (B,), "n_ref")
    j2 = torch.empty((B, Q), dtype=torch.int32, device=q.device)
    j3 = torch.empty_like(j2)
    d2 = torch.empty((B, Q), dtype=torch.float32, device=q.device)
    d3 = torch.empty_like(d2)
    launch = _build.entry("odom_corr", _ARGTYPES)
    err = launch(*(_build.ptr(t) for t in (q, ref, ring, j1, n_q, n_ref,
                                           j2, j3, d2, d3)),
                 B, Q, M, float(window), int(surf), int(truncate),
                 _build.stream_of(q))
    _build.check(err, "odom_corr")
    return j2, j3, d2, d3


def odom_correspondences(proj, q_mask, ref_xyz, ref_mask, ref_ring, n_q,
                         gate_sq: float, window: float, truncate: bool,
                         surf: bool):
    """(j1, j2[, j3]) with the reference's strict gates applied, -1 where
    no candidate qualifies (src/laserOdometry.cpp:474-651).  ref must be
    front-compacted; n_q is the current feature count (the upward-scan
    truncation bound)."""
    Q, M = proj.shape[0], ref_xyz.shape[0]
    qc, rc, n_live = recenter(proj, ref_xyz, ref_mask)
    tq = tile(Q, (256, 128, 64, 32, 16, 8))
    tm = tile(M, (512, 256, 128))
    idx1, _ = knn_topk(qc, rc, n_live.reshape(1), 1, tq=tq, tm=tm)
    j1_raw = idx1[0, :, 0].long()

    def exact_d2(j):
        d = proj - ref_xyz[j.clamp(0, M - 1)]
        return (d * d).sum(-1)

    def valid(j):
        return (j >= 0) & ref_mask[j.clamp(0, M - 1)]

    j1 = torch.where(
        q_mask & (exact_d2(j1_raw) < gate_sq) & valid(j1_raw), j1_raw, -1
    )
    j2r, j3r, _, _ = odom_corr(
        qc, rc, ref_ring.to(torch.int32)[None].contiguous(),
        j1.to(torch.int32)[None].contiguous(),
        n_q.to(torch.int32).reshape(1), n_live.reshape(1),
        surf=surf, window=window, truncate=truncate,
    )
    ok1 = j1 >= 0

    def gated(j):
        j = j[0].long()
        return torch.where(ok1 & valid(j) & (exact_d2(j) < gate_sq), j, -1)

    if not surf:
        return j1, gated(j2r)
    return j1, gated(j2r), gated(j3r)
