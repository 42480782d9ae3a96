"""Voxel-hash map store, strict exact-kNN subset (counterpart of
loam_tpu/map_store.py; src/laserMapping.cpp:64-91,446-681,980-1036).

Keys are uint32 words held in int64; every product that wraps modulo
2^32 in the JAX code is computed here in 16-bit halves so int64 never
overflows.  Insertion claims free slots with a deterministic winner
(the highest claiming row, the last writer of the JAX scatter), so
the key's two words always come from the same claimant.
"""

from __future__ import annotations

import dataclasses

import torch

from loam_tpu.config import LoamConfig

from .ops.voxel import (INVALID_HI, segment_bounds, sort_by_voxel,
                        true_div, unpack_coords2)
from .utils import rotations
from .utils.numerics import sqrt

EMPTY = INVALID_HI
_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class VoxelTable:
    key_hi: torch.Tensor   # (T,) int64 uint32 values, EMPTY when free
    key_lo: torch.Tensor   # (T,) int64
    sum_xyz: torch.Tensor  # (T, 3) float32
    cnt: torch.Tensor      # (T,) float32

    @staticmethod
    def create(size: int, device=None) -> "VoxelTable":
        return VoxelTable(
            key_hi=torch.full((size,), EMPTY, dtype=torch.int64,
                              device=device),
            key_lo=torch.zeros((size,), dtype=torch.int64, device=device),
            sum_xyz=torch.zeros((size, 3), device=device),
            cnt=torch.zeros((size,), device=device),
        )

    @property
    def size(self) -> int:
        return self.key_hi.shape[0]

    def live(self):
        return self.key_hi != EMPTY

    def centroids(self):
        return self.sum_xyz / torch.clamp(self.cnt, min=1.0)[:, None]

    def n_live(self):
        return self.live().sum(dtype=torch.int32)


def _mul_u32(a, c: int):
    """(a * c) mod 2^32 for uint32 values a (int64) and a constant c."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_u32(a, b):
    """Mix two uint32 words (splitmix-style), as map_store._hash_u32."""
    h = _mul_u32(a, 0x9E3779B1) ^ _mul_u32(b, 0x85EBCA77)
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0xC2B2AE3D)
    return h ^ (h >> 13)


def aggregate_by_voxel(xyz, mask, leaf, out_cap):
    """Per-frame unique voxels: (key_hi, key_lo, sum_xyz, cnt, valid) of
    length out_cap (corner-centred prefix-sum differences)."""
    hi_s, lo_s, xyz_s, _, valid_s, newseg, is_end = sort_by_voxel(
        xyz, mask, leaf)
    p0, p1, valid = segment_bounds(newseg, is_end, out_cap)
    cnts = torch.where(valid, (p1 - p0 + 1).to(torch.float32), 0.0)
    corner = unpack_coords2(hi_s, lo_s).to(xyz.dtype) * leaf
    vals = torch.where(valid_s[:, None], xyz_s - corner, 0.0)
    csum = torch.cumsum(vals, 0)
    sums_c = csum[p1] - csum[p0] + vals[p0]
    sums = torch.where(valid[:, None], corner[p0] * cnts[:, None] + sums_c,
                       0.0)
    out_hi = torch.where(valid, hi_s[p0], EMPTY)
    return out_hi, lo_s[p0], sums, cnts, valid


def table_insert(table: VoxelTable, key_hi, key_lo, sums, cnts, valid,
                 cfg: LoamConfig) -> VoxelTable:
    """Set-associative insert with conflict-retry rounds: a claim writes
    the key, re-reads it to verify ownership, and losers retry."""
    T = table.size
    ways = cfg.table_ways
    dev = key_hi.device
    n = key_hi.shape[0]
    base = (_hash_u32(key_hi, key_lo) % (T // ways)) * ways
    rows = torch.arange(n, device=dev)

    key_hi_t = torch.cat([table.key_hi, key_hi.new_full((1,), EMPTY)])
    key_lo_t = torch.cat([table.key_lo, key_lo.new_zeros(1)])
    sum_t = torch.cat([table.sum_xyz, table.sum_xyz.new_zeros((1, 3))])
    cnt_t = torch.cat([table.cnt, table.cnt.new_zeros(1)])

    pending = valid
    for _ in range(cfg.insert_rounds):
        ways_idx = base[:, None] + torch.arange(ways, device=dev)
        t_hi = key_hi_t[ways_idx]
        t_lo = key_lo_t[ways_idx]
        match = (t_hi == key_hi[:, None]) & (t_lo == key_lo[:, None])
        empty = t_hi == EMPTY
        has_match = match.any(1)
        has_empty = empty.any(1)
        way = torch.where(has_match, torch.argmax(match.to(torch.int8), 1),
                          torch.argmax(empty.to(torch.int8), 1))
        slot = base + way
        can = pending & (has_match | has_empty)
        claim = can & ~has_match
        claim_slot = torch.where(claim, slot, T)
        winner = torch.full((T + 1,), -1, dtype=torch.int64, device=dev)
        winner.scatter_reduce_(0, claim_slot, rows, reduce="amax")
        won_slot = torch.where(claim & (winner[claim_slot] == rows), slot, T)
        key_hi_t = key_hi_t.index_put((won_slot,), key_hi)
        key_lo_t = key_lo_t.index_put((won_slot,), key_lo)
        own = (key_hi_t[slot] == key_hi) & (key_lo_t[slot] == key_lo)
        ok = can & own
        add_slot = torch.where(ok, slot, T)
        sum_t = sum_t.index_add(0, add_slot, sums)
        cnt_t = cnt_t.index_add(0, add_slot, cnts)
        pending = pending & ~ok

    # EMA count cap (approximates VoxelGrid re-centroiding)
    cnt_new = cnt_t[:T]
    scale = torch.clamp(cfg.voxel_count_cap / torch.clamp(cnt_new, min=1e-6),
                        max=1.0)
    return VoxelTable(key_hi=key_hi_t[:T], key_lo=key_lo_t[:T],
                      sum_xyz=sum_t[:T] * scale[:, None],
                      cnt=cnt_new * scale)


def entry_cubes(table: VoxelTable):
    """50 m cube of each entry: floor((p + 25) / 50)."""
    return torch.floor(true_div(table.centroids() + 25.0, 50.0)).to(
        torch.int64)


def center_cube(pose):
    return torch.floor(true_div(pose[3:] + 25.0, 50.0)).to(torch.int64)


def evict_outside_window(table: VoxelTable, center, cfg: LoamConfig
                         ) -> VoxelTable:
    """Drop entries whose cube left the 21x11x21 window around the sensor
    cube (src/laserMapping.cpp:454-614)."""
    half = torch.tensor([cfg.grid_width // 2, cfg.grid_height // 2,
                         cfg.grid_depth // 2], device=center.device)
    inside = ((entry_cubes(table) - center).abs() <= half).all(1)
    keep = table.live() & inside
    return VoxelTable(
        key_hi=torch.where(keep, table.key_hi, EMPTY), key_lo=table.key_lo,
        sum_xyz=torch.where(keep[:, None], table.sum_xyz, 0.0),
        cnt=torch.where(keep, table.cnt, 0.0),
    )


def local_cube_fov(center, tobe, cfg: LoamConfig):
    """Which of the 5x5x5 neighbour cubes intersect the laser FOV
    (src/laserMapping.cpp:616-672).  Returns (n, n, n) bool."""
    r = cfg.local_cubes
    n = 2 * r + 1
    dev = center.device
    ar = torch.arange(-r, r + 1, device=dev)
    off = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1
                      ).reshape(-1, 3)
    centers = (center[None, :] + off).to(torch.float32) * cfg.cube_size
    pm = torch.tensor([-1.0, 1.0], device=dev)
    corner_off = torch.stack(torch.meshgrid(pm, pm, pm, indexing="ij"), -1
                             ).reshape(-1, 3) * (cfg.cube_size / 2.0)
    corners = centers[:, None, :] + corner_off[None, :, :]
    sensor = tobe[3:]
    y_pt = rotations.apply_pose(tobe, torch.tensor([0.0, 10.0, 0.0],
                                                   device=dev))
    s1 = ((sensor[None, None] - corners) ** 2).sum(-1)
    s2 = ((y_pt[None, None] - corners) ** 2).sum(-1)
    root = 10.0 * sqrt(torch.tensor(3.0, device=dev)) * sqrt(s1)
    check1 = 100.0 + s1 - s2 - root
    check2 = 100.0 + s1 - s2 + root
    return ((check1 < 0.0) & (check2 > 0.0)).any(1).reshape(n, n, n)


@dataclasses.dataclass
class LocalMap:
    """FOV-culled 5x5x5-cube map centroids, compacted and SORTED along
    the dominant-extent axis (laserCloudCornerFromMap/SurfFromMap,
    src/laserMapping.cpp:674-681)."""

    xyz: torch.Tensor       # (cap, 3)
    mask: torch.Tensor      # (cap,)
    n_local: torch.Tensor   # () int32 full keep count (may exceed cap)
    sort_axis: torch.Tensor  # () int64

    def overflow(self):
        return torch.clamp(self.n_local - self.mask.shape[-1], min=0)


def local_map_points(table: VoxelTable, center, fov, cap: int,
                     cfg: LoamConfig) -> LocalMap:
    """Compact the local-region centroids, sorted on the widest axis in
    one stable sort (dropped entries key to +BIG)."""
    cent = table.centroids()
    off = entry_cubes(table) - center[None, :]
    r = cfg.local_cubes
    in_region = table.live() & (off.abs() <= r).all(1)
    offc = (off + r).clamp(0, 2 * r)
    keep = in_region & fov[offc[:, 0], offc[:, 1], offc[:, 2]]

    big = 3.0e38
    lo = torch.where(keep[:, None], cent, big).amin(0)
    hi = torch.where(keep[:, None], cent, -big).amax(0)
    axis = torch.argmax(hi - lo)
    coord = cent.index_select(1, axis.reshape(1))[:, 0]
    order = torch.argsort(torch.where(keep, coord, big), stable=True)
    xyz = cent[order]
    n_keep = keep.sum(dtype=torch.int32)
    T = cent.shape[0]
    if cap <= T:
        xyz = xyz[:cap]
    else:
        xyz = torch.cat([xyz, xyz.new_zeros((cap - T, 3))])
    ok = torch.arange(cap, device=cent.device) < n_keep
    return LocalMap(xyz=torch.where(ok[:, None], xyz, 0.0), mask=ok,
                    n_local=n_keep, sort_axis=axis)
