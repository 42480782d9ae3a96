"""The composed 4-node reference graph, sequential.

scanRegistration -> laserOdometry -> (every 2nd frame) laserMapping ->
transformMaintenance, exactly as the rate-decoupled ROS graph runs them.
transformMaintenance re-publishes every odometry pose with the latest
mapping correction (src/transformMaintenance.cpp:147-203).
"""

from __future__ import annotations

import numpy as np

from .mapping import LaserMappingOracle, transform_associate_to_map
from .odometry import LaserOdometryOracle
from .precision import to_tf32
from .registration import scan_registration

FEATURE_CLASSES = ("sharp", "less_sharp", "flat", "less_flat")


def run_pipeline(raw_xyz, raw_mask, tf32: bool = False):
    """Replay (F, N, 3) raw sweeps through the full reference graph.
    tf32: the control, with the raw points and every matrix product at
    TF32 precision (precision.py).

    Returns a dict: odom, aft (the latest mapping pose at each frame) and
    integrated trajectories (F, 6), the per-frame mapping flags
    `mapped` (F,), and `features`, one dict a frame of the feature
    classes' internal-frame points (n, 3) float32.
    """
    raw_xyz = np.asarray(raw_xyz, np.float32)
    if tf32:
        raw_xyz = to_tf32(raw_xyz)
    odo = LaserOdometryOracle(tf32=tf32)
    mapper = LaserMappingOracle(tf32=tf32)

    F = raw_xyz.shape[0]
    odom_traj = np.zeros((F, 6))
    aft_traj = np.zeros((F, 6))
    integ_traj = np.zeros((F, 6))
    mapped = np.zeros(F, dtype=bool)
    features = []

    # transformMaintenance state (transformMaintenance.cpp:52-58)
    tm_bef = np.zeros(6)
    tm_aft = np.zeros(6)

    for f in range(F):
        feats = scan_registration(raw_xyz[f], raw_mask[f])
        features.append({c: feats[c].xyz for c in FEATURE_CLASSES})
        out = odo.handle(feats)
        odom_traj[f] = out["pose"]

        # the mapping sync gate (laserMapping.cpp:411-414) needs the
        # odometry POSE too; the odometry init frame publishes only clouds
        # (laserOdometry.cpp:427-456 continue before the pose publish), so
        # mapping first fires on the first post-init publish frame
        if out["published"] and f > 0:
            mres = mapper.handle(
                out["pose"], out["corner_last"], out["surf_last"]
            )
            mapped[f] = True
            # odomAftMappedHandler records the published pair
            # (transformMaintenance.cpp:182-203)
            tm_bef = mres["pose_bef"].copy()
            tm_aft = mres["pose_aft"].copy()

        aft_traj[f] = tm_aft
        integ_traj[f] = transform_associate_to_map(
            out["pose"], tm_bef, tm_aft
        )

    return {
        "odom": odom_traj,
        "aft": aft_traj,
        "integrated": integ_traj,
        "mapped": mapped,
        "features": features,
    }
