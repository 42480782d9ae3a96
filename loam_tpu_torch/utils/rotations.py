"""YXZ-Euler pose algebra (counterpart of loam_tpu/utils/rotations.py).

R(rx, ry, rz) = Ry(ry) @ Rx(rx) @ Rz(rz); poses are 6-vectors
[rx, ry, rz, tx, ty, tz] in the internal camera-style frame, with any
leading (scenario) axes.
"""

from __future__ import annotations

import torch

from ..types import per_scenario
from .numerics import seq_sum


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


def mat_vec(M, v):
    """M @ v for M (..., 3, 3) and v (..., 3) with the same leading
    axes, as one fixed-order elementwise expression
    ((M[:, 0] v0 + M[:, 1] v1) + M[:, 2] v2).  A batched matrix product
    picks its kernel, and so its order of additions, from the leading
    shape (cuBLAS on the card, mm against bmm on the CPU); this one
    rounds alike for one sweep and for a batch of them."""
    return seq_sum(M * v[..., None, :], -1)


def vec_mat(v, M):
    """v @ M for row vectors v (..., N, 3) and M (..., 3, 3) with the
    same leading axes, in the fixed order of mat_vec."""
    return seq_sum(v[..., :, None] * M[..., None, :, :], -2)


def r_yxz_fixed(angles):
    """r_yxz with its two 3x3 products in the fixed order of mat_vec:
    what a batched r_yxz gives on the CPU, for one rotation as for many
    and on any device (the IMU frontend's, so that one sweep rounds as a
    batch of frames does)."""
    rx, ry, rz = angles[..., 0], angles[..., 1], angles[..., 2]
    return vec_mat(vec_mat(rot_y(ry), rot_x(rx)), rot_z(rz))


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
    mapping correction composed onto the current odometry pose; poses
    (6,), or (B, 6) one scenario at a time (types.per_scenario)."""
    if transform_sum.dim() > 1:
        return per_scenario(transform_associate_to_map, transform_sum,
                            transform_bef, transform_aft)
    r_sum, t_sum = transform_sum[:3], transform_sum[3:]
    r_bef, t_bef = transform_bef[:3], transform_bef[3:]
    r_aft, t_aft = transform_aft[:3], transform_aft[3:]
    incre = r_yxz(r_sum).mT @ (t_bef - t_sum)
    r_out = euler_yxz(r_yxz(r_sum) @ r_yxz(r_bef).mT @ r_yxz(r_aft))
    t_out = t_aft - r_yxz(r_out) @ incre
    return torch.cat([r_out, t_out])


def apply_pose(pose6, points):
    """pointAssociateToMap (src/laserMapping.cpp:234-252): R p + t for
    pose6 (..., 6) and points (..., N, 3) with the same leading axes."""
    R = r_yxz(pose6[..., :3])
    return points @ R.mT + pose6[..., None, 3:]


def apply_pose_inverse(pose6, points):
    """pointAssociateTobeMapped (src/laserMapping.cpp:254-272): body
    point R^T (p - t) for pose6 (..., 6) and points (..., N, 3) with the
    same leading axes."""
    R = r_yxz(pose6[..., :3])
    return (points - pose6[..., None, 3:]) @ R


def rpy_quaternion_wxyz(roll, pitch, yaw):
    """tf::createQuaternionMsgFromRollPitchYaw (ZYX convention: q =
    Rz(yaw) Ry(pitch) Rx(roll)) as (..., 4) [w, x, y, z]; used only at
    the output boundary (src/laserOdometry.cpp:858,
    src/laserMapping.cpp:1071)."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([w, x, y, z], -1)


def pose6_to_matrix(pose6):
    """(..., 4, 4) homogeneous world-from-body matrix of a [r, t] pose."""
    M = torch.zeros(pose6.shape[:-1] + (4, 4), dtype=pose6.dtype,
                    device=pose6.device)
    M[..., :3, :3] = r_yxz(pose6[..., :3])
    M[..., :3, 3] = pose6[..., 3:]
    M[..., 3, 3] = 1.0
    return M
