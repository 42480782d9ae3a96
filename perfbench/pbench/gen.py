"""Regression traffic made on the device from a seed: B scenarios of F
VLP-16 sweeps each.

A PyTorch copy of loam_tpu_torch/io/synth.py's make_world,
straight_trajectory and simulate_sweep (the recipe of chip_smoke.py's
batch_sweeps and bench.py): each scenario is a random world of pillars
and boxes in one room, a straight path at a random speed and yaw rate
from a static anchor sweep, and 5 mm of range noise.  The geometry runs
in float64, as the NumPy original does, and the sweeps come out as
float32 Velodyne-frame points in firing order with their validity mask.
Every random number comes from one torch.Generator seeded with the run's
seed, drawn in a fixed order, so a seed gives the same inputs on a card
of the same kind.

One step is the benchmark's own, where synth's recipe can put a solid
across the sensor's path (a drive through a pillar, whose sweeps lose
up to two thirds of their returns): with the traffic's `clearance_m`,
every solid that comes within it of the path is moved sideways until it
clears the path by that much, as the body of the vehicle that carries
the sensor keeps solids away from it.  No random number is drawn for
it.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
ROOM_MIN = (-12.0, -2.0, -12.0)
ROOM_MAX = (12.0, 6.0, 40.0)
N_RINGS = 16
# rays a ray-cast chunk holds (with its boxes, some hundreds of MB)
CHUNK_RAYS = 1 << 20


def boxes_from_uniforms(u_pillars, u_boxes):
    """make_world's solids from its uniform draws in [0, 1): u_pillars
    (..., n_pillars, 3) for (cx, cz, w), u_boxes (..., n_boxes, 4) for
    (cx, cz, w, h).  Returns (boxes_min, boxes_max) (..., n, 3)."""
    def span(u, lo, hi):
        return lo + (hi - lo) * u

    cx, cz = span(u_pillars[..., 0], -9, 9), span(u_pillars[..., 1], -6, 35)
    w = span(u_pillars[..., 2], 0.3, 0.8)
    floor = torch.full_like(cx, -2.0)
    p_min = torch.stack([cx - w, floor, cz - w], -1)
    p_max = torch.stack([cx + w, floor + 8.0, cz + w], -1)
    bx, bz = span(u_boxes[..., 0], -9, 9), span(u_boxes[..., 1], -6, 35)
    bw = span(u_boxes[..., 2], 0.5, 1.6)
    h = span(u_boxes[..., 3], 0.5, 2.0)
    bfloor = torch.full_like(bx, -2.0)
    b_min = torch.stack([bx - bw, bfloor, bz - bw], -1)
    b_max = torch.stack([bx + bw, bfloor + h, bz + bw], -1)
    return torch.cat([p_min, b_min], -2), torch.cat([p_max, b_max], -2)


def straight_poses(frames: int, speed, yaw_rate, scan_period: float):
    """straight_trajectory for each scenario (speed, yaw_rate (B,)):
    (B, frames + 1, 6) poses at the sweep boundaries, yaw about y, the
    position advanced along the body's forward axis at each step."""
    steps = torch.cat([torch.zeros_like(yaw_rate[:, None]),
                       (yaw_rate * scan_period)[:, None].expand(
                           -1, frames)], 1)
    yaw = torch.cumsum(steps, 1)
    adv = (speed * scan_period)[:, None]
    step_x = torch.cat([torch.zeros_like(adv), adv * torch.sin(yaw[:, :-1])],
                       1)
    step_z = torch.cat([torch.zeros_like(adv), adv * torch.cos(yaw[:, :-1])],
                       1)
    poses = torch.zeros(speed.shape + (frames + 1, 6), dtype=F64,
                        device=speed.device)
    poses[..., 1] = yaw
    poses[..., 3] = torch.cumsum(step_x, 1)
    poses[..., 5] = torch.cumsum(step_z, 1)
    return poses


def keep_clear(bmin, bmax, poses, clearance: float):
    """Every solid (bmin / bmax (B, n, 3)) whose box comes within
    `clearance` of the box around the sensor's positions in poses
    (B, P, 6), moved along x (away from the path's middle) until its
    x-extent clears the path's by `clearance`; the others as they are.
    The path is linear between its poses, so its box holds every
    position, and a solid so moved is at least `clearance` from each."""
    pos = poses[..., 3:6]
    lo = pos.amin(1, keepdim=True) - clearance
    hi = pos.amax(1, keepdim=True) + clearance
    near = ((bmax > lo) & (bmin < hi)).all(-1)
    mid = 0.5 * (lo[..., 0] + hi[..., 0])
    right = 0.5 * (bmin[..., 0] + bmax[..., 0]) >= mid
    shift = torch.where(right, hi[..., 0] - bmin[..., 0],
                        lo[..., 0] - bmax[..., 0])
    shift = torch.where(near, shift, torch.zeros_like(shift))
    step = torch.zeros_like(bmin)
    step[..., 0] = shift
    return bmin + step, bmax + step


def ray_directions(n_azimuth: int, device):
    """Body-frame (internal) directions of one sweep's rays in firing
    order, azimuth-major with the 16 elevations inside, and each ray's
    fraction of the sweep.  The sweep turns clockwise, as a VLP-16
    does."""
    frac = torch.arange(n_azimuth, dtype=F64, device=device) / n_azimuth
    az = -(2 * math.pi) * frac
    elev = torch.deg2rad(torch.arange(-15.0, 16.0, 2.0, dtype=F64,
                                      device=device))
    a = az.repeat_interleave(N_RINGS)
    e = elev.repeat(n_azimuth)
    ce, se = torch.cos(e), torch.sin(e)
    dirs = torch.stack([ce * torch.sin(a), se, ce * torch.cos(a)], 1)
    return dirs, frac.repeat_interleave(N_RINGS)


def _room_exit(origin, dirs):
    rmin = torch.tensor(ROOM_MIN, dtype=F64, device=dirs.device)
    rmax = torch.tensor(ROOM_MAX, dtype=F64, device=dirs.device)
    t1 = (rmin - origin) / dirs
    t2 = (rmax - origin) / dirs
    tmax = torch.maximum(t1, t2)
    tmax = torch.where(torch.isfinite(tmax), tmax, math.inf)
    return tmax.amin(-1)


def _boxes_enter(origin, dirs, bmin, bmax):
    o, d = origin[..., None, :], dirs[..., None, :]
    t1 = (bmin - o) / d
    t2 = (bmax - o) / d
    tnear = torch.minimum(t1, t2).amax(-1)
    tfar = torch.maximum(t1, t2).amin(-1)
    hit = (tnear <= tfar) & (tfar > 0) & (tnear > 0.05)
    return torch.where(hit, tnear, math.inf).amin(-1)


def cast_sweeps(bmin, bmax, pose_start, pose_end, dirs, frac, noise,
                max_range: float = 80.0):
    """simulate_sweep for S sweeps of one world: bmin / bmax (n, 3),
    pose_start / pose_end (S, 6), dirs (N, 3) and frac (N,) from
    ray_directions, noise (S, N) added to every range.  The sensor moves
    linearly over each sweep.  Returns (xyz (S, N, 3) float32 in the
    Velodyne frame, mask (S, N) bool)."""
    poses = pose_start[:, None] + frac[:, None] * (pose_end - pose_start)[
        :, None]
    rx, ry, rz = poses[..., 0], poses[..., 1], poses[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    bx, by, bz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    # R = Ry Rx Rz applied to each body direction
    x1 = cz * bx - sz * by
    y1 = sz * bx + cz * by
    y2 = cx * y1 - sx * bz
    z2 = sx * y1 + cx * bz
    world = torch.stack([cy * x1 + sy * z2, y2, -sy * x1 + cy * z2], -1)
    origin = poses[..., 3:6]
    t = torch.minimum(_room_exit(origin, world),
                      _boxes_enter(origin, world, bmin, bmax))
    valid = torch.isfinite(t) & (t > 0.3) & (t < max_range)
    t = torch.where(valid, t, 1.0) + noise
    pb = t[..., None] * dirs
    xyz = torch.stack([pb[..., 2], pb[..., 0], pb[..., 1]], -1)
    return xyz.to(torch.float32), valid


def make_traffic(seed: int, traffic: dict, sensor: dict, device):
    """The cell's inputs: raw (B, F, N, 3) float32 and mask (B, F, N) bool
    on `device`.  Sweep k of a scenario spans its boundary poses k and
    k + 1, the first a static anchor sweep.  traffic gives
    scenarios, frames, pillars, boxes, speed_mps and yaw_rate_rps (each
    [lo, hi]), range_noise_m and optionally clearance_m (keep_clear);
    sensor gives azimuths and scan_period."""
    B, F = int(traffic["scenarios"]), int(traffic["frames"])
    n_az, period = int(sensor["azimuths"]), float(sensor["scan_period"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen, dtype=F64, device=device)
        return lo + (hi - lo) * u

    u_pillars = uniform((B, int(traffic["pillars"]), 3))
    u_boxes = uniform((B, int(traffic["boxes"]), 4))
    speed = uniform((B,), *traffic["speed_mps"])
    yaw_rate = uniform((B,), *traffic["yaw_rate_rps"])
    bmin, bmax = boxes_from_uniforms(u_pillars, u_boxes)
    poses = straight_poses(F, speed, yaw_rate, period)
    poses = torch.cat([poses[:, :1], poses], 1)[:, :F + 1]
    if traffic.get("clearance_m") is not None:
        bmin, bmax = keep_clear(bmin, bmax, poses,
                                float(traffic["clearance_m"]))

    dirs, frac = ray_directions(n_az, device)
    N = dirs.shape[0]
    raw = torch.empty((B, F, N, 3), dtype=torch.float32, device=device)
    mask = torch.empty((B, F, N), dtype=torch.bool, device=device)
    per_chunk = max(1, CHUNK_RAYS // N)
    sigma = float(traffic["range_noise_m"])
    for b in range(B):
        noise = sigma * torch.randn((F, N), generator=gen, dtype=F64,
                                    device=device)
        for f0 in range(0, F, per_chunk):
            f1 = min(F, f0 + per_chunk)
            raw[b, f0:f1], mask[b, f0:f1] = cast_sweeps(
                bmin[b], bmax[b], poses[b, f0:f1], poses[b, f0 + 1:f1 + 1],
                dirs, frac, noise[f0:f1])
    return raw, mask
