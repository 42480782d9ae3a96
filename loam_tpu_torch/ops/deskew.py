"""TransformToStart / TransformToEnd (counterpart of
loam_tpu/ops/deskew.py; src/laserOdometry.cpp:101-194).

Points xyz (..., N, 3) with per-point fractions s (..., N); a transform
or IMU vector is (6,) / (3,) for every point, or (..., 6) / (..., 3)
with the points' leading (scenario) axes."""

from __future__ import annotations

import torch


def _rot_seq_to_start(x, y, z, rx, ry, rz):
    """Ry(-ry) @ Rx(-rx) @ Rz(-rz), elementwise."""
    c, s = torch.cos(rz), torch.sin(rz)
    x1 = c * x + s * y
    y1 = -s * x + c * y
    z1 = z
    c, s = torch.cos(rx), torch.sin(rx)
    y2 = c * y1 + s * z1
    z2 = -s * y1 + c * z1
    c, s = torch.cos(ry), torch.sin(ry)
    return c * x1 - s * z2, y2, s * x1 + c * z2


def _per_point(v):
    """A per-scenario vector (B, k) as (B, 1, k), so that its columns
    broadcast over the point axis; a (k,) vector as it is."""
    return v[..., None, :] if v.dim() > 1 else v


def transform_to_start(xyz, s, transform):
    """p_start = Ry(-s ry) Rx(-s rx) Rz(-s rz) (p - s t).
    xyz (..., 3), s (...) or a scalar, transform (6,) or (B, 6)."""
    transform = _per_point(transform)
    t = [transform[..., i] for i in range(6)]
    rx, ry, rz = s * t[0], s * t[1], s * t[2]
    tx, ty, tz = s * t[3], s * t[4], s * t[5]
    xo, yo, zo = _rot_seq_to_start(
        xyz[..., 0] - tx, xyz[..., 1] - ty, xyz[..., 2] - tz, rx, ry, rz
    )
    return torch.stack([xo, yo, zo], -1)


def transform_to_end(xyz, s, transform, imu_start_rpy=None,
                     imu_last_rpy=None, imu_shift_from_start=None):
    """To sweep start by the per-point fraction s, then forward through
    the full motion (src/laserOdometry.cpp:126-166), then, with the IMU
    angles and shift (each (3,)), the nonlinear-motion tail
    p_end = R_imuLast^T R_imuStart (p6 - shift), R_imu = Ry(yaw) Rx(pitch)
    Rz(roll) (:168-192).  Without them the tail is left out: it is the
    identity at zero IMU angles."""
    p0 = transform_to_start(xyz, s, transform)
    x3, y3, z3 = p0[..., 0], p0[..., 1], p0[..., 2]
    transform = _per_point(transform)
    rx, ry, rz = transform[..., 0], transform[..., 1], transform[..., 2]
    c, s_ = torch.cos(ry), torch.sin(ry)
    x4 = c * x3 + s_ * z3
    z4 = -s_ * x3 + c * z3
    c, s_ = torch.cos(rx), torch.sin(rx)
    y5 = c * y3 - s_ * z4
    z5 = s_ * y3 + c * z4
    c, s_ = torch.cos(rz), torch.sin(rz)
    x6 = c * x4 - s_ * y5 + transform[..., 3]
    y6 = s_ * x4 + c * y5 + transform[..., 4]
    z6 = z5 + transform[..., 5]
    if imu_start_rpy is None:
        return torch.stack([x6, y6, z6], -1)

    start, last, shift = (_per_point(v) for v in (
        imu_start_rpy, imu_last_rpy, imu_shift_from_start))
    ps, ys, rs = start[..., 0], start[..., 1], start[..., 2]
    pl, yl, rl = last[..., 0], last[..., 1], last[..., 2]
    sx, sy, sz = shift[..., 0], shift[..., 1], shift[..., 2]
    # R_imuStart (p6 - shift): Rz(rollStart), Rx(pitchStart), Ry(yawStart)
    c, s_ = torch.cos(rs), torch.sin(rs)
    x7 = c * (x6 - sx) - s_ * (y6 - sy)
    y7 = s_ * (x6 - sx) + c * (y6 - sy)
    z7 = z6 - sz
    c, s_ = torch.cos(ps), torch.sin(ps)
    y8 = c * y7 - s_ * z7
    z8 = s_ * y7 + c * z7
    c, s_ = torch.cos(ys), torch.sin(ys)
    x9 = c * x7 + s_ * z8
    z9 = -s_ * x7 + c * z8
    # R_imuLast^T: Ry(-yawLast), Rx(-pitchLast), Rz(-rollLast)
    c, s_ = torch.cos(yl), torch.sin(yl)
    x10 = c * x9 - s_ * z9
    z10 = s_ * x9 + c * z9
    c, s_ = torch.cos(pl), torch.sin(pl)
    y11 = c * y8 + s_ * z10
    z11 = -s_ * y8 + c * z10
    c, s_ = torch.cos(rl), torch.sin(rl)
    return torch.stack([c * x10 + s_ * y11, -s_ * x10 + c * y11, z11], -1)
