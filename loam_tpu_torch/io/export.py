"""Trajectory / point-cloud export (the port's own copy of
loam_tpu/io/export.py, NumPy only, byte for byte the same files).

The reference's only output surface is rviz subscribed to its topics
(rviz_cfg/loam_velodyne.rviz:91,118,130,157 in the reference; SURVEY.md §1
L5).  Standalone equivalents: TUM-format trajectories (consumable by evo
and every SLAM eval tool) and binary little-endian PLY clouds (viewable in
CloudCompare/meshlab/Open3D).
"""

from __future__ import annotations

import struct

import numpy as np


def save_trajectory_tum(path: str, stamps, poses6) -> None:
    """TUM format: `t x y z qx qy qz qw` per line.

    poses6: (F, 6) [rx, ry, rz, tx, ty, tz] internal-frame poses.  The
    quaternion is built with the same RPY mapping the reference uses when
    publishing odometry (geoQuat from (rz, -rx, -ry) then remapped,
    src/laserOdometry.cpp:858-865).
    """
    poses6 = np.asarray(poses6, np.float64)
    stamps = np.asarray(stamps, np.float64)
    rx, ry, rz = poses6[:, 0], poses6[:, 1], poses6[:, 2]
    # tf::createQuaternionMsgFromRollPitchYaw(rz, -rx, -ry) (ZYX) ...
    cr, sr = np.cos(rz / 2), np.sin(rz / 2)
    cp, sp = np.cos(-rx / 2), np.sin(-rx / 2)
    cy, sy = np.cos(-ry / 2), np.sin(-ry / 2)
    qw = cr * cp * cy + sr * sp * sy
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    # ... then remapped into the output frame:
    # (x, y, z, w) <- (-qy, -qz, qx, qw) (src/laserOdometry.cpp:861-864)
    out_q = np.stack([-qy, -qz, qx, qw], 1)
    with open(path, "w") as f:
        for k in range(poses6.shape[0]):
            t = poses6[k, 3:6]
            q = out_q[k]
            f.write(
                f"{stamps[k]:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def load_trajectory_tum(path: str):
    """Returns (stamps (F,), positions (F, 3), quats xyzw (F, 4))."""
    rows = np.loadtxt(path).reshape(-1, 8)
    return rows[:, 0], rows[:, 1:4], rows[:, 4:8]


def save_cloud_ply(path: str, xyz, mask=None) -> None:
    """Binary little-endian PLY of the valid points."""
    xyz = np.asarray(xyz, np.float32)
    if mask is not None:
        xyz = xyz[np.asarray(mask, bool)]
    with open(path, "wb") as f:
        f.write(
            b"ply\nformat binary_little_endian 1.0\n"
            + f"element vertex {xyz.shape[0]}\n".encode()
            + b"property float x\nproperty float y\nproperty float z\n"
            + b"end_header\n"
        )
        f.write(xyz.astype("<f4").tobytes())


def load_cloud_ply(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n = None
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            if line == b"end_header":
                break
        data = np.frombuffer(f.read(n * 12), dtype="<f4")
    return data.reshape(n, 3)
