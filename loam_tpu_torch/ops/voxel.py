"""Voxel-grid centroid downsampling (counterpart of loam_tpu/ops/voxel.py;
pcl::VoxelGrid at src/scanRegistration.cpp:576-579,
src/laserMapping.cpp:693-701).

Keys are the JAX package's two uint32 words, held in int64.  Its
two-key payload sort becomes one stable sort of the composite
(key_hi << 16) | key_lo, which orders exactly like (key_hi, key_lo)
because key_lo < 2^16.  Batched over any leading axes.
"""

from __future__ import annotations

import torch

from .compact import compact_masked

_BIAS = 1 << 15
_MASK16 = (1 << 16) - 1
INVALID_HI = 0xFFFFFFFF


def true_div(x, s: float):
    """x / s rounded as IEEE division.  A CUDA tensor divided by a Python
    scalar is computed as x * (1/s), one ulp off; that moves points
    across voxel and cube boundaries, so divide by a device scalar."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def voxel_coords(xyz, leaf):
    """Integer voxel coordinates floor(p / leaf), absolute origin."""
    return torch.floor(true_div(xyz, leaf)).to(torch.int64)


def pack_coords2(cij):
    """(..., 3) int voxel coords -> (key_hi, key_lo) uint32 values in
    int64: key_hi = (z+B) << 16 | (y+B), key_lo = (x+B)."""
    c = (cij + _BIAS) & _MASK16
    return (c[..., 2] << 16) | c[..., 1], c[..., 0]


def unpack_coords2(key_hi, key_lo):
    z = (key_hi >> 16) - _BIAS
    y = (key_hi & _MASK16) - _BIAS
    x = (key_lo & _MASK16) - _BIAS
    return torch.stack([x, y, z], -1)


def sort_by_voxel(xyz, mask, leaf, extra=None):
    """Group points by voxel: one stable sort of the composite key.
    Returns (hi_s, lo_s, xyz_s, extra_s, valid_s, newseg, is_end)."""
    key_hi, key_lo = pack_coords2(voxel_coords(xyz, leaf))
    key_hi = torch.where(mask, key_hi, torch.full_like(key_hi, INVALID_HI))
    order = torch.argsort((key_hi << 16) | key_lo, dim=-1, stable=True)
    hi_s = torch.gather(key_hi, -1, order)
    lo_s = torch.gather(key_lo, -1, order)
    xyz_s = torch.gather(xyz, -2, order[..., None].expand(xyz.shape))
    ex_s = None if extra is None else torch.gather(extra, -1, order)
    valid_s = hi_s != INVALID_HI
    diff = (hi_s[..., 1:] != hi_s[..., :-1]) | (lo_s[..., 1:] != lo_s[..., :-1])
    one = torch.ones_like(diff[..., :1])
    newseg = torch.cat([one, diff], -1) & valid_s
    is_end = torch.cat([diff, one], -1) & valid_s
    return hi_s, lo_s, xyz_s, ex_s, valid_s, newseg, is_end


def segment_bounds(newseg, is_end, out_cap):
    """Per-segment (start, end) positions via two sort-compactions."""
    N = newseg.shape[-1]
    pos = torch.arange(N, dtype=torch.int64, device=newseg.device)
    pos = pos.expand(newseg.shape)
    (p0,), ok = compact_masked(newseg, (pos,), out_cap)
    (p1,), _ = compact_masked(is_end, (pos,), out_cap)
    return p0.clamp(0, N - 1), p1.clamp(0, N - 1), ok


def _take(a, idx):
    """a (..., N, 3) gathered at idx (..., C) along the point axis."""
    return torch.gather(a, -2, idx[..., None].expand(idx.shape + (3,)))


def voxel_downsample(xyz, mask, leaf, out_cap, extra=None):
    """Centroid-downsample a masked point set.

    xyz (..., N, 3), mask (..., N), extra optional (..., N) channel
    averaged per voxel.  Returns (out_xyz (..., out_cap, 3),
    out_extra (..., out_cap), out_mask (..., out_cap))."""
    hi_s, lo_s, xyz_s, ex_s, valid_s, newseg, is_end = sort_by_voxel(
        xyz, mask, leaf, extra
    )
    p0, p1, ok = segment_bounds(newseg, is_end, out_cap)
    cnt = torch.where(ok, (p1 - p0 + 1).to(xyz.dtype), 0.0)
    denom = torch.clamp(cnt, min=1.0)

    # prefix sums centred on each voxel's corner keep the prefix
    # magnitude bounded by N*leaf (see loam_tpu/ops/voxel.py)
    corner = unpack_coords2(hi_s, lo_s).to(xyz.dtype) * leaf
    vals = torch.where(valid_s[..., None], xyz_s - corner, 0.0)
    csum = torch.cumsum(vals, dim=-2)
    sums = _take(csum, p1) - _take(csum, p0) + _take(vals, p0)
    out_xyz = torch.where(
        ok[..., None], _take(corner, p0) + sums / denom[..., None], 0.0
    )

    if extra is None:
        out_extra = torch.zeros(ok.shape, dtype=xyz.dtype, device=xyz.device)
    else:
        # centred on each segment's first value, as the JAX code does
        seg = torch.cumsum(newseg.to(torch.int64), -1) - 1
        first = torch.gather(ex_s, -1, p0)
        exv = torch.where(
            valid_s,
            ex_s - torch.gather(first, -1, seg.clamp(0, out_cap - 1)),
            0.0,
        )
        ecs = torch.cumsum(exv, -1)
        ex_sum = (torch.gather(ecs, -1, p1) - torch.gather(ecs, -1, p0)
                  + torch.gather(exv, -1, p0))
        out_extra = torch.where(ok, first + ex_sum / denom, 0.0)
    return out_xyz, out_extra, ok & (cnt > 0)
