"""YXZ-Euler pose algebra (counterpart of loam_tpu/utils/rotations.py).

R(rx, ry, rz) = Ry(ry) @ Rx(rx) @ Rz(rz); poses are 6-vectors
[rx, ry, rz, tx, ty, tz] in the internal camera-style frame.
"""

from __future__ import annotations

import torch


def _rot(a, rows):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    env = {"c": c, "s": s, "-s": -s, "-c": -c, "o": o, "z": z}
    return torch.stack(
        [torch.stack([env[e] for e in row], -1) for row in rows], -2
    )


def rot_x(a):
    return _rot(a, (("o", "z", "z"), ("z", "c", "-s"), ("z", "s", "c")))


def rot_y(a):
    return _rot(a, (("c", "z", "s"), ("z", "o", "z"), ("-s", "z", "c")))


def rot_z(a):
    return _rot(a, (("c", "-s", "z"), ("s", "c", "z"), ("z", "z", "o")))


def drot_x(a):
    """d rot_x(a) / da."""
    return _rot(a, (("z", "z", "z"), ("z", "-s", "-c"), ("z", "c", "-s")))


def drot_y(a):
    return _rot(a, (("-s", "z", "c"), ("z", "z", "z"), ("-c", "z", "-s")))


def drot_z(a):
    return _rot(a, (("-s", "-c", "z"), ("c", "-s", "z"), ("z", "z", "z")))


def r_yxz(angles):
    """R = Ry(ry) @ Rx(rx) @ Rz(rz) for angles (..., 3) = (rx, ry, rz)."""
    rx, ry, rz = angles[..., 0], angles[..., 1], angles[..., 2]
    return rot_y(ry) @ rot_x(rx) @ rot_z(rz)


def euler_yxz(R):
    """(rx, ry, rz) with R == Ry(ry) @ Rx(rx) @ Rz(rz)."""
    rx = torch.asin(torch.clamp(-R[..., 1, 2], -1.0, 1.0))
    cx = torch.cos(rx)
    ry = torch.atan2(R[..., 0, 2] / cx, R[..., 2, 2] / cx)
    rz = torch.atan2(R[..., 1, 0] / cx, R[..., 1, 1] / cx)
    return torch.stack([rx, ry, rz], -1)


def accumulate_rotation(c_angles, l_angles):
    """AccumulateRotation (src/laserOdometry.cpp:256-273)."""
    return euler_yxz(r_yxz(c_angles) @ r_yxz(l_angles))


def plugin_imu_rotation(bc, bl, al):
    """PluginIMURotation (src/laserOdometry.cpp:196-254):
    angles of R(bc) @ R(bl)^T @ R(al)."""
    return euler_yxz(r_yxz(bc) @ r_yxz(bl).mT @ r_yxz(al))


def transform_associate_to_map(transform_sum, transform_bef, transform_aft):
    """transformAssociateToMap (src/laserMapping.cpp:110-197): the latest
    mapping correction composed onto the current odometry pose."""
    r_sum, t_sum = transform_sum[:3], transform_sum[3:]
    r_bef, t_bef = transform_bef[:3], transform_bef[3:]
    r_aft, t_aft = transform_aft[:3], transform_aft[3:]
    incre = r_yxz(r_sum).mT @ (t_bef - t_sum)
    r_out = euler_yxz(r_yxz(r_sum) @ r_yxz(r_bef).mT @ r_yxz(r_aft))
    t_out = t_aft - r_yxz(r_out) @ incre
    return torch.cat([r_out, t_out])


def apply_pose(pose6, points):
    """pointAssociateToMap (src/laserMapping.cpp:234-252): R p + t."""
    R = r_yxz(pose6[:3])
    return points @ R.T + pose6[3:]
