"""Sweep ingest: raw Velodyne cloud -> ring-organized Sweep (counterpart
of loam_tpu/frontend.py; src/scanRegistration.cpp:211-357), no-IMU
branch, batched over any leading axes (frames)."""

from __future__ import annotations

import math

import torch

from loam_tpu.config import LoamConfig

from .types import Sweep
from .utils.numerics import sqrt


def velodyne_to_internal(xyz_velo):
    """(x, y, z)_velo -> internal (y, z, x): z forward, x left, y up."""
    return torch.stack(
        [xyz_velo[..., 1], xyz_velo[..., 2], xyz_velo[..., 0]], -1
    )


def ring_id(xyz, n_scans: int):
    """VLP-16 elevation -> scan id (src/scanRegistration.cpp:248-256).
    Returns (scan_id int64, in_range)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    angle = torch.atan2(y, sqrt(x * x + z * z)) * (180.0 / math.pi)
    rounded = torch.trunc(
        angle + torch.where(angle < 0.0, -0.5, 0.5)
    ).to(torch.int64)
    scan_id = torch.where(rounded > 0, rounded, rounded + (n_scans - 1))
    return scan_id, (scan_id >= 0) & (scan_id <= n_scans - 1)


def unwrap_azimuth(ori, mask):
    """Monotonic phase unwrap of ori over arrival order (the halfPassed
    state machine, src/scanRegistration.cpp:262-281).  The JAX package's
    associative scan (carry the last valid ori forward) becomes a
    cumulative max over valid positions plus a gather."""
    n = ori.shape[-1]
    pos = torch.arange(n, device=ori.device)
    first_idx = torch.argmax(mask.to(torch.int8), dim=-1, keepdim=True)
    start = torch.gather(ori, -1, first_idx)
    # the last valid ori at or before each slot; slots before the first
    # valid one get a placeholder, never read (their delta is masked)
    last_valid = torch.cummax(torch.where(mask, pos, 0), dim=-1).values
    filled = torch.gather(ori, -1, last_valid)
    prev_filled = torch.cat([filled[..., :1], filled[..., :-1]], -1)
    delta = ori - prev_filled
    delta = torch.remainder(delta + math.pi, 2 * math.pi) - math.pi
    delta = torch.where(mask & (pos > first_idx), delta, 0.0)
    return start + torch.cumsum(delta, -1), start


def ingest_sweep(xyz_velo, mask, cfg: LoamConfig = LoamConfig()) -> Sweep:
    """Organize raw sweeps (..., N, 3) + validity (..., N) into ring-major
    Sweeps with the ring + scanPeriod*relTime channel
    (src/scanRegistration.cpp:283-284, :350-357)."""
    xyz = velodyne_to_internal(xyz_velo.to(torch.float32))
    scan_id, ring_ok = ring_id(xyz, cfg.n_scans)
    valid = mask & ring_ok

    ori = -torch.atan2(xyz[..., 0], xyz[..., 2])
    unwrapped, start = unwrap_azimuth(ori, valid)
    n = xyz.shape[-2]
    last_idx = n - 1 - torch.argmax(
        valid.flip(-1).to(torch.int8), dim=-1, keepdim=True
    )
    end = torch.gather(unwrapped, -1, last_idx)
    span = torch.where((end - start).abs() < 1e-6, 2 * math.pi, end - start)
    rel_time = (unwrapped - start) / span
    rel = scan_id.to(torch.float32) + cfg.scan_period * rel_time

    # ring-major reorganization: stable sort by ring, then gather each
    # (ring, rank) slot's source point
    ring_key = torch.where(valid, scan_id, cfg.n_scans)
    order = torch.argsort(ring_key, dim=-1, stable=True)
    rings = torch.arange(cfg.n_scans, device=xyz.device)
    counts = (ring_key[..., None, :] == rings[:, None]).sum(-1)
    ring_starts = torch.cumsum(counts, -1) - counts
    W = cfg.ring_width
    w_iota = torch.arange(W, device=xyz.device)
    src_pos = ring_starts[..., None] + w_iota                 # (..., S, W)
    ok = w_iota < counts[..., None]
    lead = src_pos.shape[:-2]
    src = torch.gather(
        order, -1, src_pos.clamp(0, n - 1).reshape(lead + (-1,))
    )
    xyz_g = torch.gather(xyz, -2, src[..., None].expand(src.shape + (3,)))
    rel_g = torch.gather(rel, -1, src)
    shape = lead + (cfg.n_scans, W)
    return Sweep(
        xyz=torch.where(ok[..., None], xyz_g.reshape(shape + (3,)), 0.0),
        rel=torch.where(ok, rel_g.reshape(shape), 0.0),
        mask=ok,
    )
