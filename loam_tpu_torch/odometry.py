"""Scan-to-scan odometry (counterpart of loam_tpu/odometry.py;
src/laserOdometry.cpp), no-IMU form.

The correspondence search runs through the port's kernels (1-NN, then
the ring walks of ops/cuda/odom_corr).  The Gauss-Newton loop keeps the
JAX structure: re-association rounds of `reassociate_every` masked
iterations, with one host read of the convergence flag per round.  The
degeneracy projector needs an eigendecomposition, whose torch form syncs
with the card; it runs only until the host has seen that the projector
is set (normally at the first iteration only).
"""

from __future__ import annotations

import dataclasses

import torch

from loam_tpu.config import LoamConfig

from .ops import residuals
from .ops.cuda.odom_corr import odom_correspondences
from .ops.deskew import transform_to_end, transform_to_start
from .types import FeatureClouds, PointCloud
from .utils import linalg, rotations
from .utils.numerics import sqrt


@dataclasses.dataclass
class OdomState:
    corner_last: PointCloud      # previous less-sharp, end-projected
    surf_last: PointCloud        # previous less-flat, end-projected
    transform: torch.Tensor      # (6,) frame-to-frame motion (warm start)
    transform_sum: torch.Tensor  # (6,) accumulated odometry pose
    initialized: torch.Tensor    # () bool
    frame_count: torch.Tensor    # () int32 (skip-frame phase)
    nan_skips: torch.Tensor      # () int32

    @staticmethod
    def create(cfg: LoamConfig, device=None) -> "OdomState":
        return OdomState(
            corner_last=PointCloud.zeros(cfg.max_less_sharp, device),
            surf_last=PointCloud.zeros(cfg.max_less_flat, device),
            transform=torch.zeros(6, device=device),
            transform_sum=torch.zeros(6, device=device),
            initialized=torch.tensor(False, device=device),
            frame_count=torch.tensor(cfg.skip_frame_num, dtype=torch.int32,
                                     device=device),
            nan_skips=torch.tensor(0, dtype=torch.int32, device=device),
        )


@dataclasses.dataclass
class OdomOutput:
    pose: torch.Tensor               # (6,) /laser_odom_to_init
    corner_last: PointCloud          # /laser_cloud_corner_last
    surf_last: PointCloud            # /laser_cloud_surf_last
    full: PointCloud                 # /velodyne_cloud_3
    publish_to_mapping: torch.Tensor  # () bool


def _gather(cloud: PointCloud, idx):
    return cloud.xyz[idx.clamp(min=0)]


def _odom_residuals(transform, late, sharp, flat, corner_last, surf_last,
                    corr, cfg: LoamConfig):
    """One linearization (src/laserOdometry.cpp:530-583, 653-694)."""
    cj1, cj2, sj1, sj2, sj3 = corr
    proj_c = transform_to_start(sharp.xyz, sharp.sweep_time(), transform)
    dir_c, d_c = residuals.point_to_line(
        proj_c, _gather(corner_last, cj1), _gather(corner_last, cj2))
    s_c = torch.where(late, 1.0 - cfg.odom_weight_slope * d_c.abs(), 1.0)
    keep_c = ((cj2 >= 0) & sharp.mask & (s_c > cfg.weight_keep_threshold)
              & (d_c != 0.0))

    proj_s = transform_to_start(flat.xyz, flat.sweep_time(), transform)
    normal, pd = residuals.plane_from_tripod(
        _gather(surf_last, sj1), _gather(surf_last, sj2),
        _gather(surf_last, sj3))
    d_s = residuals.point_to_plane(proj_s, normal, pd)
    range_fac = sqrt(sqrt(torch.clamp(
        (proj_s * proj_s).sum(-1), min=1e-12)))
    s_s = torch.where(
        late, 1.0 - cfg.odom_weight_slope * d_s.abs() / range_fac, 1.0)
    keep_s = ((sj2 >= 0) & (sj3 >= 0) & flat.mask
              & (s_s > cfg.weight_keep_threshold) & (d_s != 0.0))

    points = torch.cat([sharp.xyz, flat.xyz])
    coeffs = torch.cat([s_c[:, None] * dir_c, s_s[:, None] * normal])
    rhs = torch.cat([s_c * d_c, s_s * d_s])
    keep = torch.cat([keep_c, keep_s])
    return points, coeffs, rhs, keep


def _odom_associate(transform, feats: FeatureClouds, corner_last,
                    surf_last, cfg: LoamConfig):
    """One correspondence re-association (src/laserOdometry.cpp:474-651)."""
    sharp, flat = feats.sharp, feats.flat
    proj_c = transform_to_start(sharp.xyz, sharp.sweep_time(), transform)
    proj_s = transform_to_start(flat.xyz, flat.sweep_time(), transform)
    common = dict(gate_sq=cfg.odom_nn_gate_sq, window=cfg.ring_window,
                  truncate=cfg.emulate_upward_scan_truncation)
    cj1, cj2 = odom_correspondences(
        proj_c, sharp.mask, corner_last.xyz, corner_last.mask,
        corner_last.ring(), sharp.count(), surf=False, **common)
    sj1, sj2, sj3 = odom_correspondences(
        proj_s, flat.mask, surf_last.xyz, surf_last.mask,
        surf_last.ring(), flat.count(), surf=True, **common)
    return cj1, cj2, sj1, sj2, sj3


def gauss_newton_odometry(transform0, feats: FeatureClouds,
                          corner_last: PointCloud, surf_last: PointCloud,
                          cfg: LoamConfig):
    """The <= odom_max_iters GN loop, re-associating every
    reassociate_every iterations, with the first-solve degeneracy
    projector, NaN guard and 0.1 deg / 0.1 cm convergence
    (src/laserOdometry.cpp:470-827).  Returns (transform, nan_skip)."""
    sharp, flat = feats.sharp, feats.flat
    dev = transform0.device
    N = sharp.capacity + flat.capacity
    c = dict(
        it=torch.tensor(0, dtype=torch.int32, device=dev),
        transform=transform0,
        converged=torch.tensor(False, device=dev),
        P=torch.eye(6, device=dev),
        degenerate=torch.tensor(False, device=dev),
        have_P=torch.tensor(False, device=dev),
        nan_skip=torch.tensor(0, dtype=torch.int32, device=dev),
        # laserCloudOri/coeffSel append semantics as per-point outer
        # product accumulators (src/laserOdometry.cpp:458-459,580-581)
        Cacc=torch.zeros((N, 3, 3), device=dev),
        bacc=torch.zeros((N, 3), device=dev),
        n_rows=torch.tensor(0, dtype=torch.int32, device=dev),
    )
    host_have_P = False

    def iteration(c, corr):
        nonlocal host_have_P
        transform = c["transform"]
        active = ~c["converged"] & (c["it"] < cfg.odom_max_iters)
        late = c["it"] >= cfg.odom_weight_start_iter
        points, coeffs, rhs, keep = _odom_residuals(
            transform, late, sharp, flat, corner_last, surf_last, corr, cfg)
        keep = keep & active
        coeffs = torch.where(keep[:, None], coeffs, 0.0)
        rhs = torch.where(keep, rhs, 0.0)
        n_sel = keep.sum(dtype=torch.int32)
        if cfg.odom_accumulate_rows:
            Cacc = c["Cacc"] + coeffs[:, :, None] * coeffs[:, None, :]
            bacc = c["bacc"] + coeffs * (-cfg.odom_rhs_scale * rhs)[:, None]
            n_rows = c["n_rows"] + n_sel
            J = residuals.odom_point_jacobians(points, transform)
            ata, atb = residuals.normal_equations_accumulated(J, Cacc, bacc)
        else:
            Cacc, bacc, n_rows = c["Cacc"], c["bacc"], n_sel
            rows = residuals.odom_jacobian_rows(points, coeffs, transform)
            ata, atb = residuals.normal_equations(
                rows, -cfg.odom_rhs_scale * rhs, keep)
        enough = n_rows >= cfg.odom_min_correspondences
        x = linalg.solve_sym6(ata, atb)

        P, degenerate, have_P = c["P"], c["degenerate"], c["have_P"]
        if not host_have_P:
            need_P = active & enough & ~have_P
            P_new, deg_new = linalg.degeneracy_projector(
                ata, cfg.odom_degen_eigen_threshold)
            P = torch.where(need_P, P_new, P)
            degenerate = torch.where(need_P, deg_new, degenerate)
            have_P = have_P | need_P
            host_have_P = bool(have_P)  # eigh has already synced
        x = torch.where(degenerate, P @ x, x)

        is_nan = torch.isnan(x).any() | torch.isinf(x).any()
        x = torch.where(is_nan, 0.0, x)
        do_update = active & enough & ~is_nan
        new_transform = torch.where(do_update, transform + x, transform)
        delta_r = sqrt((torch.rad2deg(x[:3]) ** 2).sum())
        delta_t = sqrt(((x[3:] * 100.0) ** 2).sum())
        converged = c["converged"] | (
            do_update & (delta_r < cfg.odom_delta_r_break_deg)
            & (delta_t < cfg.odom_delta_t_break_cm))
        act_i = active.to(torch.int32)
        return dict(
            it=c["it"] + act_i, transform=new_transform, converged=converged,
            P=P, degenerate=degenerate, have_P=have_P,
            nan_skip=c["nan_skip"] + (is_nan & enough).to(torch.int32) * act_i,
            Cacc=Cacc, bacc=bacc, n_rows=n_rows,
        )

    n_rounds = -(-cfg.odom_max_iters // cfg.reassociate_every)
    for _ in range(n_rounds):
        corr = _odom_associate(c["transform"], feats, corner_last, surf_last,
                               cfg)
        for _ in range(cfg.reassociate_every):
            c = iteration(c, corr)
        if bool(c["converged"]):   # the round's one host sync
            break
    return c["transform"], c["nan_skip"]


def accumulate_pose(transform_sum, transform, cfg: LoamConfig):
    """Compose the frame motion onto the global pose with the 1.05 scale
    on ry / tz (src/laserOdometry.cpp:830-856); the IMU rotation plug-in
    runs with zero IMU angles, as the JAX code does without an IMU."""
    neg = torch.stack([-transform[0], -transform[1] * cfg.odom_y_scale,
                       -transform[2]])
    r_new = rotations.accumulate_rotation(transform_sum[:3], neg)
    v = torch.stack([transform[3], transform[4],
                     transform[5] * cfg.odom_y_scale])
    t_new = transform_sum[3:] - rotations.r_yxz(r_new) @ v
    zero = torch.zeros(3, device=transform.device)
    r_new = rotations.plugin_imu_rotation(r_new, zero, zero)
    return torch.cat([r_new, t_new])


def _project_cloud_to_end(cloud: PointCloud, transform):
    xyz = transform_to_end(cloud.xyz, cloud.sweep_time(), transform)
    # TransformToEnd resets the fractional sweep time (:193)
    return cloud.replace(
        xyz=torch.where(cloud.mask[:, None], xyz, 0.0),
        rel=torch.floor(cloud.rel),
    )


def odometry_step(state: OdomState, feats: FeatureClouds,
                  cfg: LoamConfig = LoamConfig()):
    """One odometry frame (src/laserOdometry.cpp:410-931), unbatched
    feature clouds.  Returns (new_state, OdomOutput)."""
    if not bool(state.initialized):
        # first frame: hand the clouds over, no solve, no pose publish
        # (src/laserOdometry.cpp:427-456)
        new_state = dataclasses.replace(
            state, corner_last=feats.less_sharp, surf_last=feats.less_flat,
            initialized=torch.ones_like(state.initialized))
        return new_state, OdomOutput(
            pose=state.transform_sum, corner_last=feats.less_sharp,
            surf_last=feats.less_flat, full=feats.full,
            publish_to_mapping=torch.zeros_like(state.initialized))

    transform = state.transform
    nan_skip = torch.zeros_like(state.nan_skips)
    can_solve = ((state.corner_last.count() > cfg.odom_min_corner_last)
                 & (state.surf_last.count() > cfg.odom_min_surf_last))
    if bool(can_solve):
        transform, nan_skip = gauss_newton_odometry(
            transform, feats, state.corner_last, state.surf_last, cfg)

    tsum = accumulate_pose(state.transform_sum, transform, cfg)
    corner_next = _project_cloud_to_end(feats.less_sharp, transform)
    surf_next = _project_cloud_to_end(feats.less_flat, transform)

    frame_count = state.frame_count + 1
    publish = frame_count >= cfg.skip_frame_num + 1
    full = feats.full
    if bool(publish):
        full = _project_cloud_to_end(full, transform)
    frame_count = torch.where(publish, 0, frame_count).to(torch.int32)

    new_state = OdomState(
        corner_last=corner_next, surf_last=surf_next, transform=transform,
        transform_sum=tsum, initialized=state.initialized,
        frame_count=frame_count, nan_skips=state.nan_skips + nan_skip,
    )
    return new_state, OdomOutput(
        pose=tsum, corner_last=corner_next, surf_last=surf_next, full=full,
        publish_to_mapping=publish)
