"""TransformToStart / TransformToEnd (counterpart of
loam_tpu/ops/deskew.py; src/laserOdometry.cpp:101-194), no-IMU form."""

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


def transform_to_start(xyz, s, transform):
    """p_start = Ry(-s ry) Rx(-s rx) Rz(-s rz) (p - s t).
    xyz (..., 3), s (...) or a scalar, transform (6,)."""
    rx, ry, rz = s * transform[0], s * transform[1], s * transform[2]
    tx, ty, tz = s * transform[3], s * transform[4], s * transform[5]
    xo, yo, zo = _rot_seq_to_start(
        xyz[..., 0] - tx, xyz[..., 1] - ty, xyz[..., 2] - tz, rx, ry, rz
    )
    return torch.stack([xo, yo, zo], -1)


def transform_to_end(xyz, s, transform):
    """To sweep start by the per-point fraction s, then forward through
    the full motion (src/laserOdometry.cpp:126-166).  Without an IMU the
    reference's nonlinear-motion tail is the identity, exactly."""
    p0 = transform_to_start(xyz, s, transform)
    x3, y3, z3 = p0[..., 0], p0[..., 1], p0[..., 2]
    rx, ry, rz = transform[0], transform[1], transform[2]
    c, s_ = torch.cos(ry), torch.sin(ry)
    x4 = c * x3 + s_ * z3
    z4 = -s_ * x3 + c * z3
    c, s_ = torch.cos(rx), torch.sin(rx)
    y5 = c * y3 - s_ * z4
    z5 = s_ * y3 + c * z4
    c, s_ = torch.cos(rz), torch.sin(rz)
    x6 = c * x4 - s_ * y5 + transform[3]
    y6 = s_ * x4 + c * y5 + transform[4]
    z6 = z5 + transform[5]
    return torch.stack([x6, y6, z6], -1)
