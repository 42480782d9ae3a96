"""Voxel-hash map store and the per-frame search structures: the sorted
local map of the exact-kNN modes and the cell-bucket search grid
(counterpart of loam_tpu/map_store.py;
src/laserMapping.cpp:64-91,446-681,707-719,980-1036).

Keys are uint32 words held in int64; every product that wraps modulo
2^32 in the JAX code is computed here in 16-bit halves so int64 never
overflows.  Insertion claims free slots with a deterministic winner
(the highest claiming row, the last writer of the JAX scatter), so
the key's two words always come from the same claimant.

Every table, query set and search structure may carry leading
(scenario) axes in front of its own; scenarios never mix.  Where an
index runs into a flat buffer, each scenario's indices are offset into
its own span of it.
"""

from __future__ import annotations

import dataclasses

import torch

from . import resolve_device
from .config import LoamConfig
from .ops.cuda.kselect import knn_select
from .ops.voxel import (INVALID_HI, segment_bounds, sort_by_voxel,
                        true_div, unpack_coords2)
from .utils import rotations
from .utils.numerics import sqrt

EMPTY = INVALID_HI
_U32 = 0xFFFFFFFF


def _take(a, idx):
    """a (..., N, 3) gathered at idx (..., C) along the point axis."""
    return torch.gather(a, -2, idx[..., None].expand(idx.shape + (3,)))


@dataclasses.dataclass
class VoxelTable:
    key_hi: torch.Tensor   # (..., T) int64 uint32 values, EMPTY when free
    key_lo: torch.Tensor   # (..., T) int64
    sum_xyz: torch.Tensor  # (..., T, 3) float32
    cnt: torch.Tensor      # (..., T) float32

    @staticmethod
    def create(size: int, device=None,
               batch: int | None = None) -> "VoxelTable":
        """device: None is the CUDA device (raises without one); batch:
        None for one table, B for a leading scenario axis."""
        device = resolve_device(device)
        shape = (size,) if batch is None else (batch, size)
        return VoxelTable(
            key_hi=torch.full(shape, EMPTY, dtype=torch.int64,
                              device=device),
            key_lo=torch.zeros(shape, dtype=torch.int64, device=device),
            sum_xyz=torch.zeros(shape + (3,), device=device),
            cnt=torch.zeros(shape, device=device),
        )

    @property
    def size(self) -> int:
        return self.key_hi.shape[-1]

    def live(self):
        return self.key_hi != EMPTY

    def centroids(self):
        return self.sum_xyz / torch.clamp(self.cnt, min=1.0)[..., None]

    def n_live(self):
        return self.live().sum(-1, dtype=torch.int32)


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
    vals = torch.where(valid_s[..., None], xyz_s - corner, 0.0)
    csum = torch.cumsum(vals, -2)
    sums_c = _take(csum, p1) - _take(csum, p0) + _take(vals, p0)
    sums = torch.where(valid[..., None],
                       _take(corner, p0) * cnts[..., None] + sums_c, 0.0)
    out_hi = torch.where(valid, torch.gather(hi_s, -1, p0), EMPTY)
    return out_hi, torch.gather(lo_s, -1, p0), sums, cnts, valid


def table_insert(table: VoxelTable, key_hi, key_lo, sums, cnts, valid,
                 cfg: LoamConfig) -> VoxelTable:
    """Set-associative insert with conflict-retry rounds: a claim writes
    the key, re-reads it to verify ownership, and losers retry.  Each
    scenario's table and its dump slot live in one span of T + 1 slots
    of a flat buffer."""
    T = table.size
    ways = cfg.table_ways
    dev = key_hi.device
    lead, n = key_hi.shape[:-1], key_hi.shape[-1]
    key_hi, key_lo = key_hi.reshape(-1, n), key_lo.reshape(-1, n)
    S = key_hi.shape[0]
    span = (torch.arange(S, device=dev) * (T + 1))[:, None]      # (S, 1)
    base = (_hash_u32(key_hi, key_lo) % (T // ways)) * ways + span
    rows = torch.arange(n, device=dev).expand(S, n)
    dump = span + T

    def flat(a, fill):
        a = a.reshape((S, T) + a.shape[len(lead) + 1:])
        pad = torch.full_like(a[:, :1], fill)
        return torch.cat([a, pad], 1).reshape((S * (T + 1),) + a.shape[2:])

    key_hi_t = flat(table.key_hi, EMPTY)
    key_lo_t = flat(table.key_lo, 0)
    sum_t = flat(table.sum_xyz, 0.0)
    cnt_t = flat(table.cnt, 0.0)
    sums = sums.reshape(S * n, 3)
    cnts = cnts.reshape(S * n)

    pending = valid.reshape(S, n)
    for _ in range(cfg.insert_rounds):
        ways_idx = base[..., None] + torch.arange(ways, device=dev)
        t_hi = key_hi_t[ways_idx]
        t_lo = key_lo_t[ways_idx]
        match = (t_hi == key_hi[..., None]) & (t_lo == key_lo[..., None])
        empty = t_hi == EMPTY
        has_match = match.any(-1)
        has_empty = empty.any(-1)
        way = torch.where(has_match, torch.argmax(match.to(torch.int8), -1),
                          torch.argmax(empty.to(torch.int8), -1))
        slot = base + way
        can = pending & (has_match | has_empty)
        claim = can & ~has_match
        claim_slot = torch.where(claim, slot, dump)
        winner = torch.full((S * (T + 1),), -1, dtype=torch.int64,
                            device=dev)
        winner.scatter_reduce_(0, claim_slot.reshape(-1), rows.reshape(-1),
                               reduce="amax")
        won_slot = torch.where(claim & (winner[claim_slot] == rows), slot,
                               dump)
        key_hi_t = key_hi_t.index_put((won_slot.reshape(-1),),
                                      key_hi.reshape(-1))
        key_lo_t = key_lo_t.index_put((won_slot.reshape(-1),),
                                      key_lo.reshape(-1))
        own = (key_hi_t[slot] == key_hi) & (key_lo_t[slot] == key_lo)
        ok = can & own
        add_slot = torch.where(ok, slot, dump).reshape(-1)
        sum_t = sum_t.index_add(0, add_slot, sums)
        cnt_t = cnt_t.index_add(0, add_slot, cnts)
        pending = pending & ~ok

    def cut(a):
        a = a.reshape((S, T + 1) + a.shape[1:])[:, :T]
        return a.reshape(lead + (T,) + a.shape[2:])

    # EMA count cap (approximates VoxelGrid re-centroiding)
    cnt_new = cut(cnt_t)
    scale = torch.clamp(cfg.voxel_count_cap / torch.clamp(cnt_new, min=1e-6),
                        max=1.0)
    return VoxelTable(key_hi=cut(key_hi_t), key_lo=cut(key_lo_t),
                      sum_xyz=cut(sum_t) * scale[..., None],
                      cnt=cnt_new * scale)


def entry_cubes(table: VoxelTable):
    """50 m cube of each entry: floor((p + 25) / 50)."""
    return torch.floor(true_div(table.centroids() + 25.0, 50.0)).to(
        torch.int64)


def center_cube(pose):
    return torch.floor(true_div(pose[..., 3:] + 25.0, 50.0)).to(torch.int64)


def evict_outside_window(table: VoxelTable, center, cfg: LoamConfig
                         ) -> VoxelTable:
    """Drop entries whose cube left the 21x11x21 window around the sensor
    cube (src/laserMapping.cpp:454-614)."""
    half = torch.tensor([cfg.grid_width // 2, cfg.grid_height // 2,
                         cfg.grid_depth // 2], device=center.device)
    inside = ((entry_cubes(table) - center[..., None, :]).abs()
              <= half).all(-1)
    keep = table.live() & inside
    return VoxelTable(
        key_hi=torch.where(keep, table.key_hi, EMPTY), key_lo=table.key_lo,
        sum_xyz=torch.where(keep[..., None], table.sum_xyz, 0.0),
        cnt=torch.where(keep, table.cnt, 0.0),
    )


def local_cube_fov(center, tobe, cfg: LoamConfig):
    """Which of the 5x5x5 neighbour cubes intersect the laser FOV
    (src/laserMapping.cpp:616-672).  Returns (..., n, n, n) bool."""
    r = cfg.local_cubes
    n = 2 * r + 1
    dev = center.device
    ar = torch.arange(-r, r + 1, device=dev)
    off = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1
                      ).reshape(-1, 3)
    centers = (center[..., None, :] + off).to(torch.float32) * cfg.cube_size
    pm = torch.tensor([-1.0, 1.0], device=dev)
    corner_off = torch.stack(torch.meshgrid(pm, pm, pm, indexing="ij"), -1
                             ).reshape(-1, 3) * (cfg.cube_size / 2.0)
    corners = centers[..., :, None, :] + corner_off
    sensor = tobe[..., None, None, 3:]
    y_pt = rotations.apply_pose(tobe, torch.tensor([[0.0, 10.0, 0.0]],
                                                   device=dev))[..., None, :, :]
    s1 = ((sensor - corners) ** 2).sum(-1)
    s2 = ((y_pt - corners) ** 2).sum(-1)
    root = 10.0 * sqrt(torch.tensor(3.0, device=dev)) * sqrt(s1)
    check1 = 100.0 + s1 - s2 - root
    check2 = 100.0 + s1 - s2 + root
    hit = ((check1 < 0.0) & (check2 > 0.0)).any(-1)
    return hit.reshape(hit.shape[:-1] + (n, n, n))


def _in_local_region(table: VoxelTable, center, fov, cfg: LoamConfig):
    """(..., T) bool: live entries of the 5x5x5 cubes around `center`
    whose cube the FOV test kept."""
    off = entry_cubes(table) - center[..., None, :]
    r = cfg.local_cubes
    n = 2 * r + 1
    in_region = table.live() & (off.abs() <= r).all(-1)
    offc = (off + r).clamp(0, 2 * r)
    cube = (offc[..., 0] * n + offc[..., 1]) * n + offc[..., 2]
    fov = fov.reshape(fov.shape[:-3] + (n * n * n,))
    return in_region & torch.gather(fov, -1, cube)


@dataclasses.dataclass
class LocalMap:
    """FOV-culled 5x5x5-cube map centroids, compacted and SORTED along
    the dominant-extent axis (laserCloudCornerFromMap/SurfFromMap,
    src/laserMapping.cpp:674-681)."""

    xyz: torch.Tensor       # (..., cap, 3)
    mask: torch.Tensor      # (..., cap)
    n_local: torch.Tensor   # (...) int32 full keep count (may exceed cap)
    sort_axis: torch.Tensor  # (...) int64

    def overflow(self):
        return torch.clamp(self.n_local - self.mask.shape[-1], min=0)


def local_map_points(table: VoxelTable, center, fov, cap: int,
                     cfg: LoamConfig) -> LocalMap:
    """Compact the local-region centroids, sorted on the widest axis in
    one stable sort (dropped entries key to +BIG)."""
    cent = table.centroids()
    keep = _in_local_region(table, center, fov, cfg)

    big = 3.0e38
    lo = torch.where(keep[..., None], cent, big).amin(-2)
    hi = torch.where(keep[..., None], cent, -big).amax(-2)
    axis = torch.argmax(hi - lo, -1)
    T = cent.shape[-2]
    coord = torch.gather(cent, -1, axis[..., None, None].expand(
        axis.shape + (T, 1)))[..., 0]
    order = torch.argsort(torch.where(keep, coord, big), dim=-1, stable=True)
    xyz = _take(cent, order)
    n_keep = keep.sum(-1, dtype=torch.int32)
    if cap <= T:
        xyz = xyz[..., :cap, :]
    else:
        xyz = torch.cat([xyz, xyz.new_zeros(xyz.shape[:-2] + (cap - T, 3))],
                        -2)
    ok = torch.arange(cap, device=cent.device) < n_keep[..., None]
    return LocalMap(xyz=torch.where(ok[..., None], xyz, 0.0), mask=ok,
                    n_local=n_keep, sort_axis=axis)


# ---------------------------------------------------------------------------
# per-frame search grid (fixed-width buckets of search_cell cells)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchGrid:
    """Dense-bucketed per-frame search grid: a query's 27-cell
    neighbourhood gathers as 27 contiguous (cap, 3) rows."""

    xyz: torch.Tensor      # (..., B, cap, 3) bucket-major coordinates
    valid: torch.Tensor    # (..., B, cap) slot validity
    n_local: torch.Tensor  # (...) int32 live entries in the local region


def _cell_bucket(cell, n_buckets: int):
    """Hash bucket of integer cells (..., 3) int64, negative ones
    included.  The JAX code multiplies int32 cells by the primes with
    wrap-around and reinterprets the result as uint32; the low 32 bits
    of the two's-complement cell times the prime are those same bits."""
    c = cell & _U32
    h = _hash_u32(
        _mul_u32(c[..., 0], 73856093) ^ _mul_u32(c[..., 1], 19349663),
        _mul_u32(c[..., 2], 83492791))
    return h % n_buckets


def _cells(xyz, cfg: LoamConfig):
    return torch.floor(true_div(xyz, cfg.search_cell)).to(torch.int64)


def build_search_grid(table: VoxelTable, center, fov, cfg: LoamConfig
                      ) -> SearchGrid:
    """Bucket the local-region (5x5x5 cubes, FOV-culled) map centroids by
    search cell, the per-frame analogue of the kd-tree rebuild.  A
    bucket keeps its first `search_bucket_cap` entries in table order
    (stable sort), as the JAX code does."""
    B, cap = cfg.search_buckets, cfg.search_bucket_cap
    cent = table.centroids()
    keep = _in_local_region(table, center, fov, cfg)
    lead, T = keep.shape[:-1], keep.shape[-1]
    cent, keep = cent.reshape(-1, T, 3), keep.reshape(-1, T)
    S = keep.shape[0]
    dev = cent.device
    bucket = torch.where(keep, _cell_bucket(_cells(cent, cfg), B), B)
    order = torch.argsort(bucket, dim=-1, stable=True)
    bucket_s = torch.gather(bucket, -1, order)
    starts = torch.searchsorted(
        bucket_s, torch.arange(B + 1, device=dev).repeat(S, 1))
    rank = torch.arange(T, device=dev) - torch.gather(starts, -1, bucket_s)
    ok = (bucket_s < B) & (rank < cap)
    # live slots are written once each; every other entry lands in its
    # scenario's dump slot B * cap (always with ok = False), cut off below
    span = B * cap + 1
    slot = torch.where(ok, bucket_s * cap + rank, B * cap) \
        + (torch.arange(S, device=dev) * span)[:, None]
    dense = cent.new_zeros((S * span, 3))
    dense[slot.reshape(-1)] = _take(cent, order).reshape(-1, 3)
    dvalid = torch.zeros(S * span, dtype=torch.bool, device=dev)
    dvalid[slot.reshape(-1)] = ok.reshape(-1)
    return SearchGrid(
        xyz=dense.reshape(S, span, 3)[:, :-1].reshape(lead + (B, cap, 3)),
        valid=dvalid.reshape(S, span)[:, :-1].reshape(lead + (B, cap)),
        n_local=keep.sum(-1, dtype=torch.int32).reshape(lead))


def _neighbor_offsets(device):
    ar = torch.arange(-1, 2, device=device)
    return torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1
                       ).reshape(-1, 3)


def knn_candidates(grid: SearchGrid, q_xyz, q_mask, k: int,
                   cfg: LoamConfig):
    """The k nearest 27-cell-neighbourhood candidates of each query: the
    expensive gather, run once per round and re-ranked by
    knn_from_candidates in the iterations after.  Several of the 27
    cells may share a bucket; its points then appear more than once
    and stay separate entries.  q_xyz (..., Q, 3) with the grid's
    leading axes.  Returns (cand (..., Q, k, 3), valid (..., Q, k)).

    Queries go through in cfg.knn_query_chunk chunks (the same query
    range of every scenario in one selection), which bounds the
    (scenarios, chunk, 27 * cap, 3) gather intermediate."""
    Q = q_xyz.shape[-2]
    cap = cfg.search_bucket_cap
    n_b = cfg.search_buckets
    offsets = _neighbor_offsets(q_xyz.device)
    lead = q_xyz.shape[:-2]
    grid_xyz = grid.xyz.reshape(-1, cap, 3)
    grid_valid = grid.valid.reshape(-1, cap)
    S = grid_xyz.shape[0] // n_b
    first = (torch.arange(S, device=q_xyz.device) * n_b).reshape(
        lead + (1, 1))

    def one_chunk(qx, qm):
        c = qx.shape[-2]
        cells = _cells(qx, cfg)[..., None, :] + offsets      # (..., c, 27, 3)
        buckets = _cell_bucket(cells, n_b) + first
        cand = grid_xyz[buckets].reshape(lead + (c, 27 * cap, 3))
        valid = grid_valid[buckets].reshape(lead + (c, 27 * cap)) \
            & qm[..., None]
        return _kselect(cand, valid, qx, k)

    chunk = cfg.knn_query_chunk
    if chunk <= 0 or Q <= chunk or Q % chunk:
        pts, d2 = one_chunk(q_xyz, q_mask)
    else:
        parts = [one_chunk(q_xyz[..., i:i + chunk, :],
                           q_mask[..., i:i + chunk])
                 for i in range(0, Q, chunk)]
        pts = torch.cat([p for p, _ in parts], -3)
        d2 = torch.cat([d for _, d in parts], -2)
    return pts, d2 < 1e29


def knn_from_candidates(cand, cand_valid, q_xyz, k: int):
    """k-NN of each query within its cached candidate set: cand
    (..., Q, C, 3), cand_valid (..., Q, C); returns (pts (..., Q, k, 3),
    d2 (..., Q, k)) nearest first."""
    return _kselect(cand, cand_valid, q_xyz, k)


def knn_search(grid: SearchGrid, q_xyz, q_mask, k: int, cfg: LoamConfig):
    """k-NN among the 27-cell neighbourhood of each query, exact within
    the reference's 1 m^2 gate (src/laserMapping.cpp:717-719,824-826).
    Returns (pts (..., Q, k, 3), d2 (..., Q, k)) nearest first."""
    cand, valid = knn_candidates(grid, q_xyz, q_mask, k, cfg)
    return knn_from_candidates(cand, valid, q_xyz, k)


def _kselect(cand, valid, q_xyz, k: int):
    """Fused distance + k-smallest selection over every query of every
    scenario as one (rows, C) selection: the CUDA kernel on a CUDA
    tensor, its plain version on a CPU tensor (ops/cuda/kselect)."""
    lead, C = q_xyz.shape[:-1], cand.shape[-2]
    pts, d2 = knn_select(cand.reshape(-1, C, 3), valid.reshape(-1, C),
                         q_xyz.reshape(-1, 3), k)
    return pts.reshape(lead + (k, 3)), d2.reshape(lead + (k,))
