"""k nearest of each query's own candidate points: CUDA kernel wrapper
and plain version (counterpart of loam_tpu/ops/pallas/kselect.py).

Contract (kernel and plain version): cand (Q, C, 3) float32, valid
(Q, C) bool, q (Q, 3) float32, 1 <= k <= C <= MAX_C.  Returns pts
(Q, k, 3) and d2 (Q, k), nearest first.  Distances are (c - q)^2 in
the IEEE order round(round(dx^2 + dy^2) + dz^2), 1e30 for
an invalid candidate.  The picks are k distinct candidate indices in
ascending (distance, index) order, the rule of a stable top-k: equal
distances go to the lower index, duplicated candidates stay separate
entries, and with fewer than k valid candidates the tail holds the
lowest-index invalid ones (d2 = 1e30; callers gate on d2).  A
distance that overflows is +inf, the value a pick is retired to: once
only +inf distances are left, every further pick is candidate 0 at
+inf, as repeated argmins give it.  NaN coordinates of a query or of a
valid candidate are outside the contract.
``knn_select.launches`` counts kernel launches, ``knn_select.by_shape``
them by (C, k).
"""

from __future__ import annotations

import ctypes

import torch

from ..nn import BIG
from . import _build

# the most candidates a row of csrc/kselect.cu (kselect_max_c; C = 27 x
# search_bucket_cap up to a cap of 662); here for the configuration
# check, which runs without the library
MAX_C = 17880
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def _check_sizes(C: int, k: int) -> None:
    if not 1 <= k <= C <= MAX_C:
        raise ValueError(
            f"knn_select: k={k}, C={C} outside 1 <= k <= C <= {MAX_C}")


def masked_sq_dists(cand, valid, q):
    """(Q, C) squared distances, BIG where invalid."""
    d = cand[..., 0] - q[:, None, 0]
    d2 = d * d
    d = cand[..., 1] - q[:, None, 1]
    d2 = d2 + d * d
    d = cand[..., 2] - q[:, None, 2]
    return torch.where(valid, d2 + d * d, BIG)


def knn_select_plain(cand, valid, q, k: int):
    """The contract above in plain torch: k first-occurrence argmins,
    each pick retired to +inf, then a gather of the coordinates."""
    _check_sizes(cand.shape[1], k)
    d2 = masked_sq_dists(cand, valid, q)
    idx, out = [], []
    for _ in range(k):
        i = torch.argmin(d2, dim=1, keepdim=True)
        out.append(torch.gather(d2, 1, i))
        idx.append(i)
        d2 = d2.scatter(1, i, float("inf"))
    idx = torch.cat(idx, 1)
    pts = torch.gather(cand, 1, idx[..., None].expand(-1, -1, 3))
    return pts, torch.cat(out, 1)


def _launch(cand, valid, q, k: int):
    Q, C = valid.shape
    _check_sizes(C, k)
    _build.require(cand, torch.float32, (Q, C, 3), "cand")
    _build.require(valid, torch.bool, (Q, C), "valid")
    _build.require(q, torch.float32, (Q, 3), "q")
    pts = torch.empty((Q, k, 3), dtype=torch.float32, device=q.device)
    d2 = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    launch = _build.entry("kselect", _ARGTYPES)
    err = launch(*(_build.ptr(t) for t in (cand, valid, q, pts, d2)),
                 Q, C, k, _build.stream_of(q))
    _build.check(err, "kselect")
    return pts, d2


def knn_select(cand, valid, q, k: int):
    """k-NN of each query within its candidate set (Pallas
    _kselect_kernel).  The kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        return knn_select_plain(cand, valid, q, k)
    out = _launch(cand.contiguous(), valid.contiguous(), q.contiguous(), k)
    knn_select.launches += 1
    shape = (cand.shape[1], k)
    knn_select.by_shape[shape] = knn_select.by_shape.get(shape, 0) + 1
    return out


knn_select.launches = 0
knn_select.by_shape = {}
