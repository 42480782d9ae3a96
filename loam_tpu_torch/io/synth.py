"""Synthetic VLP-16 world simulator (host-side, NumPy; the port's own
copy of loam_tpu/io/synth.py, array for array).

The repository ships no lidar data (the reference's validation bags
are external downloads, CMakeLists.txt:45-51), so correctness and
benchmarks run on ray-cast synthetic worlds with exact ground-truth
trajectories: axis-aligned rooms (interior walls), pillars, and boxes give
the edge/plane structure LOAM's features need.

Sweeps are simulated with intra-sweep motion (constant-velocity pose
interpolation) so the motion-deskew model is actually exercised, and
emitted in raw Velodyne sensor frame (x forward, y left, z up) in firing
order — the ingest frontend does the reference's axis remap / ring id /
azimuth unwrap (src/scanRegistration.cpp:243-284).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# VLP-16 elevation angles in firing order are irrelevant here; we emit
# azimuth-major blocks (all 16 elevations per azimuth step), matching the
# arrival order the reference assumes (time ~ azimuth).
VLP16_ELEVATIONS_DEG = np.arange(-15.0, 16.0, 2.0)  # -15..15, 16 rings


@dataclasses.dataclass
class World:
    """Axis-aligned geometry in the *internal* frame (x left, y up,
    z forward): one room interior + solid boxes (pillars etc.)."""

    room_min: np.ndarray  # (3,)
    room_max: np.ndarray  # (3,)
    boxes_min: np.ndarray  # (B, 3)
    boxes_max: np.ndarray  # (B, 3)


def make_world(seed: int = 0, n_pillars: int = 6, n_boxes: int = 4) -> World:
    rng = np.random.default_rng(seed)
    room_min = np.array([-12.0, -2.0, -12.0])
    room_max = np.array([12.0, 6.0, 40.0])
    mins, maxs = [], []
    for _ in range(n_pillars):
        cx = rng.uniform(-9, 9)
        cz = rng.uniform(-6, 35)
        w = rng.uniform(0.3, 0.8)
        mins.append([cx - w, -2.0, cz - w])
        maxs.append([cx + w, 6.0, cz + w])
    for _ in range(n_boxes):
        cx = rng.uniform(-9, 9)
        cz = rng.uniform(-6, 35)
        w = rng.uniform(0.5, 1.6)
        h = rng.uniform(0.5, 2.0)
        mins.append([cx - w, -2.0, cz - w])
        maxs.append([cx + w, -2.0 + h, cz + w])
    return World(
        room_min=room_min,
        room_max=room_max,
        boxes_min=np.array(mins, dtype=np.float64),
        boxes_max=np.array(maxs, dtype=np.float64),
    )


def _ray_room_exit(origin, dirs, rmin, rmax):
    """Distance to the interior wall of the room (exit t of an AABB from
    inside), vectorized over rays (N, 3)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (rmin[None, :] - origin) / dirs
        t2 = (rmax[None, :] - origin) / dirs
    tmax = np.maximum(t1, t2)
    tmax = np.where(np.isfinite(tmax), tmax, np.inf)
    return np.min(tmax, axis=1)


def _ray_boxes_enter(origin, dirs, bmin, bmax):
    """Nearest positive entry distance into any solid box.  origin (N,3)
    (per-ray origins), dirs (N,3), boxes (B,3)."""
    if bmin.shape[0] == 0:
        return np.full(dirs.shape[0], np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (bmin[None, :, :] - origin[:, None, :]) / dirs[:, None, :]
        t2 = (bmax[None, :, :] - origin[:, None, :]) / dirs[:, None, :]
    tnear = np.max(np.minimum(t1, t2), axis=2)
    tfar = np.min(np.maximum(t1, t2), axis=2)
    hit = (tnear <= tfar) & (tfar > 0) & (tnear > 0.05)
    tnear = np.where(hit, tnear, np.inf)
    return np.min(tnear, axis=1)


def _pose_matrix(pose):
    """Internal-frame pose [rx, ry, rz, tx, ty, tz] -> (R, t) with
    R = Ry(ry) @ Rx(rx) @ Rz(rz) (the reference's YXZ convention)."""
    rx, ry, rz = pose[0], pose[1], pose[2]
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Ry @ Rx @ Rz, np.asarray(pose[3:6])


def simulate_sweep(
    world: World,
    pose_start,
    pose_end,
    n_azimuth: int = 900,
    noise: float = 0.005,
    max_range: float = 80.0,
    seed: int = 0,
):
    """Simulate one motion-distorted sweep.

    pose_start/pose_end: internal-frame 6-poses at sweep start/end; the
    sensor moves linearly (and slerps angles linearly — fine for the small
    per-sweep rotations LOAM assumes) over the sweep.

    Returns (xyz_velodyne (N,3) float32 in firing order, mask (N,)).
    """
    rng = np.random.default_rng(seed)
    n_rings = VLP16_ELEVATIONS_DEG.shape[0]
    elev = np.deg2rad(VLP16_ELEVATIONS_DEG)

    # firing order: azimuth-major; azimuth 0..2pi over the sweep
    # clockwise sweep (matching the real VLP-16 rotation sense): the
    # reference's azimuth phase ori = -atan2(y_velo, x_velo) must INCREASE
    # over the sweep or its halfPassed unwrap produces garbage relTime
    # (src/scanRegistration.cpp:230-284)
    az = -(2 * np.pi) * (np.arange(n_azimuth) / n_azimuth)
    frac = np.arange(n_azimuth) / n_azimuth  # time fraction per column

    a_grid = np.repeat(az, n_rings)
    e_grid = np.tile(elev, n_azimuth)
    f_grid = np.repeat(frac, n_rings)

    # body-frame (internal) ray directions:
    # velodyne (ce*ca, ce*sa, se) -> internal (y_v, z_v, x_v)
    ce, se = np.cos(e_grid), np.sin(e_grid)
    ca, sa = np.cos(a_grid), np.sin(a_grid)
    dir_body = np.stack([ce * sa, se, ce * ca], axis=1)  # internal frame

    p0 = np.asarray(pose_start, np.float64)
    p1 = np.asarray(pose_end, np.float64)
    poses = p0[None, :] + f_grid[:, None] * (p1 - p0)[None, :]

    # rotate dirs to world, origin per-ray
    # (vectorized: build all rotation matrices)
    Rs = np.stack([_pose_matrix(p)[0] for p in poses[:: n_rings * 8]])
    # interpolate coarsely: recompute exactly instead (cheap enough)
    del Rs
    dirs_w = np.empty_like(dir_body)
    origins = poses[:, 3:6]
    # chunked exact rotation
    rx, ry, rz = poses[:, 0], poses[:, 1], poses[:, 2]
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    bx, by, bz = dir_body[:, 0], dir_body[:, 1], dir_body[:, 2]
    # R = Ry Rx Rz applied to b
    x1 = cz * bx - sz * by
    y1 = sz * bx + cz * by
    z1 = bz
    y2 = cx * y1 - sx * z1
    z2 = sx * y1 + cx * z1
    dirs_w[:, 0] = cy * x1 + sy * z2
    dirs_w[:, 1] = y2
    dirs_w[:, 2] = -sy * x1 + cy * z2

    t_room = _ray_room_exit(origins, dirs_w, world.room_min, world.room_max)
    t_box = _ray_boxes_enter(origins, dirs_w, world.boxes_min, world.boxes_max)
    t = np.minimum(t_room, t_box)
    valid = np.isfinite(t) & (t > 0.3) & (t < max_range)
    t = np.where(valid, t, 1.0)
    if noise > 0:
        t = t + rng.normal(0, noise, t.shape)

    # measured point in body frame = t * dir_body; back to velodyne frame
    pb = t[:, None] * dir_body
    xyz_velo = np.stack([pb[:, 2], pb[:, 0], pb[:, 1]], axis=1)  # (x_v,y_v,z_v)
    return xyz_velo.astype(np.float32), valid


def simulate_sweep_traj(
    world: World,
    pose_fn,
    t0: float,
    scan_period: float = 0.1,
    n_azimuth: int = 900,
    noise: float = 0.005,
    max_range: float = 80.0,
    seed: int = 0,
):
    """Like simulate_sweep but with an arbitrary (possibly nonlinear)
    continuous trajectory ``pose_fn(t) -> pose6``; each firing samples the
    exact pose at its timestamp, so intra-sweep acceleration distorts the
    cloud the way a real moving sensor would."""
    n_rings = VLP16_ELEVATIONS_DEG.shape[0]
    f_grid = np.repeat(np.arange(n_azimuth) / n_azimuth, n_rings)
    times = t0 + f_grid * scan_period
    poses = np.stack([pose_fn(t) for t in np.unique(times)])
    # map each point to its azimuth step pose
    step = np.repeat(np.arange(n_azimuth), n_rings)
    poses_pt = poses[step]

    rng = np.random.default_rng(seed)
    elev = np.deg2rad(VLP16_ELEVATIONS_DEG)
    # clockwise sweep (matching the real VLP-16 rotation sense): the
    # reference's azimuth phase ori = -atan2(y_velo, x_velo) must INCREASE
    # over the sweep or its halfPassed unwrap produces garbage relTime
    # (src/scanRegistration.cpp:230-284)
    az = -(2 * np.pi) * (np.arange(n_azimuth) / n_azimuth)
    a_grid = np.repeat(az, n_rings)
    e_grid = np.tile(elev, n_azimuth)
    ce, se = np.cos(e_grid), np.sin(e_grid)
    ca, sa = np.cos(a_grid), np.sin(a_grid)
    dir_body = np.stack([ce * sa, se, ce * ca], axis=1)

    origins = poses_pt[:, 3:6]
    rx, ry, rz = poses_pt[:, 0], poses_pt[:, 1], poses_pt[:, 2]
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    bx, by, bz = dir_body[:, 0], dir_body[:, 1], dir_body[:, 2]
    x1 = cz * bx - sz * by
    y1 = sz * bx + cz * by
    z1 = bz
    y2 = cx * y1 - sx * z1
    z2 = sx * y1 + cx * z1
    dirs_w = np.stack([cy * x1 + sy * z2, y2, -sy * x1 + cy * z2], axis=1)

    t_room = _ray_room_exit(origins, dirs_w, world.room_min, world.room_max)
    t_box = _ray_boxes_enter(origins, dirs_w, world.boxes_min, world.boxes_max)
    t = np.minimum(t_room, t_box)
    valid = np.isfinite(t) & (t > 0.3) & (t < max_range)
    t = np.where(valid, t, 1.0)
    if noise > 0:
        t = t + rng.normal(0, noise, t.shape)
    pb = t[:, None] * dir_body
    xyz_velo = np.stack([pb[:, 2], pb[:, 0], pb[:, 1]], axis=1)
    return xyz_velo.astype(np.float32), valid


def simulate_imu_window(
    pose_fn,
    t0: float,
    scan_period: float = 0.1,
    rate: float = 200.0,
    capacity: int = 64,
    margin: float = 0.03,
):
    """Synthesize one sweep's window of IMU samples from the continuous
    trajectory: exact orientation (pitch, yaw, roll) == (rx, ry, rz), and
    body-frame coordinate acceleration a_b = R^T a_world from central
    differences — what the reference's imuHandler produces after gravity
    removal (src/scanRegistration.cpp:643-647).

    Returns (t (C,), rpy (C,3), acc (C,3), mask (C,)) numpy arrays.
    """
    ts = np.arange(t0 - margin, t0 + scan_period + margin, 1.0 / rate)
    ts = ts[:capacity]
    n = ts.shape[0]
    h = 1e-3
    rpy = np.zeros((capacity, 3))
    acc = np.zeros((capacity, 3))
    for i, t in enumerate(ts):
        p = pose_fn(t)
        rpy[i] = p[:3]
        a_w = (pose_fn(t + h)[3:6] - 2 * p[3:6] + pose_fn(t - h)[3:6]) / h**2
        R, _ = _pose_matrix(p)
        acc[i] = R.T @ a_w
    t_out = np.zeros(capacity)
    t_out[:n] = ts
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return (
        t_out.astype(np.float32),
        rpy.astype(np.float32),
        acc.astype(np.float32),
        mask,
    )


def accel_trajectory(speed_amp: float = 1.5, period: float = 0.8,
                     yaw_amp: float = 0.0, yaw_period: float = 1.0):
    """A smooth trajectory with strong intra-sweep acceleration:
    z(t) with sinusoidally varying speed (and optional yaw oscillation) —
    the gates_oscillating_motion analogue.  Returns pose_fn(t)."""
    w = 2 * np.pi / period
    wy = 2 * np.pi / yaw_period

    def pose_fn(t):
        p = np.zeros(6)
        # position: integral of speed_amp * sin^2-ish profile
        p[5] = speed_amp * (t / 2 - np.sin(2 * w * t) / (4 * w))
        if yaw_amp:
            p[1] = yaw_amp * np.sin(wy * t)
        return p

    return pose_fn


def oscillating_trajectory(speed: float = 0.8,
                           pitch_amp: float = 0.06, pitch_period: float = 0.7,
                           roll_amp: float = 0.05, roll_period: float = 0.9,
                           yaw_amp: float = 0.08, yaw_period: float = 1.3,
                           surge_amp: float = 0.6, surge_period: float = 0.5):
    """The gates_oscillating_motion analogue
    (the reference's README.md:25,37-38): continuous rocking in pitch,
    roll and yaw plus an oscillating surge speed — aggressive enough that
    the constant-velocity deskew model breaks and IMU aiding becomes
    load-bearing.  Returns pose_fn(t) -> internal-frame 6-pose."""
    wp = 2 * np.pi / pitch_period
    wr = 2 * np.pi / roll_period
    wy = 2 * np.pi / yaw_period
    ws = 2 * np.pi / surge_period

    def pose_fn(t):
        p = np.zeros(6)
        p[0] = pitch_amp * np.sin(wp * t)
        p[1] = yaw_amp * np.sin(wy * t)
        p[2] = roll_amp * np.sin(wr * t + 0.7)
        # forward position: integral of speed + surge_amp*sin(ws t)
        p[5] = speed * t + surge_amp * (1 - np.cos(ws * t)) / ws
        return p

    return pose_fn


def straight_trajectory(n_frames: int, speed: float = 1.0, yaw_rate: float = 0.0,
                        scan_period: float = 0.1):
    """Ground-truth internal-frame poses for a constant-twist trajectory.
    Returns (n_frames + 1, 6): pose at each sweep boundary."""
    poses = np.zeros((n_frames + 1, 6))
    pos = np.zeros(3)
    yaw = 0.0
    for k in range(n_frames + 1):
        poses[k, 1] = yaw
        poses[k, 3:6] = pos
        # advance along body forward (internal z) rotated by yaw about y
        fwd = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        pos = pos + speed * scan_period * fwd
        yaw = yaw + yaw_rate * scan_period
    return poses


def figure8_trajectory(n_frames: int, scan_period: float = 0.1,
                       speed: float = 1.2):
    """A gentler curving trajectory staying inside the default room."""
    poses = np.zeros((n_frames + 1, 6))
    pos = np.array([0.0, 0.0, 0.0])
    yaw = 0.0
    for k in range(n_frames + 1):
        poses[k, 1] = yaw
        poses[k, 3:6] = pos
        yaw_rate = 0.35 * np.sin(2 * np.pi * k / max(n_frames, 1) * 2)
        fwd = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        pos = pos + speed * scan_period * fwd
        yaw = yaw + yaw_rate * scan_period
    return poses
