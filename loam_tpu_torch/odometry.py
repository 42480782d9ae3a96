"""Scan-to-scan odometry (counterpart of loam_tpu/odometry.py;
src/laserOdometry.cpp), with the IMU priors when an ImuTrans is given.

The core runs a batch of B scenarios in lockstep (a leading axis on
every state and feature tensor); an unbatched state is its B=1 case.
The correspondence search runs through the port's kernels (1-NN, then
the ring walks of ops/cuda/odom_corr), one launch each for the batch.
The Gauss-Newton loop keeps the JAX structure: re-association rounds of
`reassociate_every` masked iterations, with one host read of the
batch's convergence flags per round; a scenario that has converged, or
cannot solve, is frozen by its `active` mask, as vmap of the JAX loop
freezes it.  The degeneracy projector needs an eigendecomposition,
whose torch form syncs with the card; it runs only until the host has
seen that every active scenario's projector is set (normally at the
first iteration only).
"""

from __future__ import annotations

import dataclasses

import torch

from . import resolve_device
from .config import LoamConfig
from .ops import residuals
from .ops.cuda.odom_corr import odom_correspondences
from .ops.deskew import transform_to_end, transform_to_start
from .ops.cuda.knn_topk import take_points
from .types import (FeatureClouds, ImuTrans, PointCloud, add_scenario_axis,
                    drop_scenario_axis, per_scenario, where_tree)
from .utils import linalg, rotations
from .utils.numerics import seq_sum, sqrt


@dataclasses.dataclass
class OdomState:
    """Shapes for one scenario; a batch puts a leading B on each."""

    corner_last: PointCloud      # previous less-sharp, end-projected
    surf_last: PointCloud        # previous less-flat, end-projected
    transform: torch.Tensor      # (6,) frame-to-frame motion (warm start)
    transform_sum: torch.Tensor  # (6,) accumulated odometry pose
    initialized: torch.Tensor    # () bool
    frame_count: torch.Tensor    # () int32 (skip-frame phase)
    nan_skips: torch.Tensor      # () int32

    @staticmethod
    def create(cfg: LoamConfig, device=None,
               batch: int | None = None) -> "OdomState":
        """device: None is the CUDA device (raises without one); batch:
        None for one scenario, B for a leading scenario axis.

        The skip-frame counter starts at skip_frame_num, as the C++'s
        frameCount = skipFrameNum (src/laserOdometry.cpp:51,886): the
        first solved frame (frame 1) publishes to mapping, then every
        (skip_frame_num + 1)-th, which is pipeline.mapping_frame.
        loam_tpu starts it at a fixed 1 (loam_tpu/odometry.py:46), the
        same cadence only at skip_frame_num <= 1: at 2 it maps frames
        2, 5, ... where its own mapping_frame and static core map
        1, 4, ... (tests/test_torch_cadence.py)."""
        device = resolve_device(device)
        lead = () if batch is None else (batch,)
        return OdomState(
            corner_last=PointCloud.zeros(cfg.max_less_sharp, device, lead),
            surf_last=PointCloud.zeros(cfg.max_less_flat, device, lead),
            transform=torch.zeros(lead + (6,), device=device),
            transform_sum=torch.zeros(lead + (6,), device=device),
            initialized=torch.zeros(lead, dtype=torch.bool, device=device),
            frame_count=torch.full(lead, cfg.skip_frame_num,
                                   dtype=torch.int32, device=device),
            nan_skips=torch.zeros(lead, dtype=torch.int32, device=device),
        )


@dataclasses.dataclass
class OdomOutput:
    pose: torch.Tensor               # (6,) /laser_odom_to_init
    corner_last: PointCloud          # /laser_cloud_corner_last
    surf_last: PointCloud            # /laser_cloud_surf_last
    full: PointCloud                 # /velodyne_cloud_3
    publish_to_mapping: torch.Tensor  # () bool


def _gather(cloud: PointCloud, idx):
    return take_points(cloud.xyz, idx.clamp(min=0))


def _odom_residuals(transform, late, sharp, flat, corner_last, surf_last,
                    corr, cfg: LoamConfig):
    """One linearization (src/laserOdometry.cpp:530-583, 653-694)."""
    cj1, cj2, sj1, sj2, sj3 = corr
    proj_c = transform_to_start(sharp.xyz, sharp.sweep_time(cfg.scan_period),
                                transform)
    dir_c, d_c = residuals.point_to_line(
        proj_c, _gather(corner_last, cj1), _gather(corner_last, cj2))
    late = late[:, None]
    s_c = torch.where(late, 1.0 - cfg.odom_weight_slope * d_c.abs(), 1.0)
    keep_c = ((cj2 >= 0) & sharp.mask & (s_c > cfg.weight_keep_threshold)
              & (d_c != 0.0))

    proj_s = transform_to_start(flat.xyz, flat.sweep_time(cfg.scan_period),
                                transform)
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

    points = torch.cat([sharp.xyz, flat.xyz], 1)
    coeffs = torch.cat([s_c[..., None] * dir_c, s_s[..., None] * normal], 1)
    rhs = torch.cat([s_c * d_c, s_s * d_s], 1)
    keep = torch.cat([keep_c, keep_s], 1)
    return points, coeffs, rhs, keep


def _odom_associate(transform, feats: FeatureClouds, corner_last,
                    surf_last, cfg: LoamConfig):
    """One correspondence re-association (src/laserOdometry.cpp:474-651),
    batched (transform (B, 6)) or for one scenario (transform (6,))."""
    sharp, flat = feats.sharp, feats.flat
    proj_c = transform_to_start(sharp.xyz, sharp.sweep_time(cfg.scan_period),
                                transform)
    proj_s = transform_to_start(flat.xyz, flat.sweep_time(cfg.scan_period),
                                transform)
    common = dict(gate_sq=cfg.odom_nn_gate_sq, window=cfg.ring_window,
                  truncate=cfg.emulate_upward_scan_truncation)
    cj1, cj2 = odom_correspondences(
        proj_c, sharp.mask, corner_last.xyz, corner_last.mask,
        corner_last.ring(), sharp.count(), surf=False, **common)
    sj1, sj2, sj3 = odom_correspondences(
        proj_s, flat.mask, surf_last.xyz, surf_last.mask,
        surf_last.ring(), flat.count(), surf=True, **common)
    return cj1, cj2, sj1, sj2, sj3


def _still_active(c, can_run, max_iters: int):
    return can_run & ~c["converged"] & (c["it"] < max_iters)


def gauss_newton_odometry(transform0, feats: FeatureClouds,
                          corner_last: PointCloud, surf_last: PointCloud,
                          cfg: LoamConfig, can_run):
    """The <= odom_max_iters GN loop, re-associating every
    reassociate_every iterations, with the first-solve degeneracy
    projector, NaN guard and 0.1 deg / 0.1 cm convergence
    (src/laserOdometry.cpp:470-827), for B scenarios in lockstep:
    transform0 (B, 6), can_run (B,) bool the scenarios that solve; the
    others keep transform0.  Returns (transform, nan_skip)."""
    sharp, flat = feats.sharp, feats.flat
    B = transform0.shape[0]
    dev = transform0.device
    N = sharp.capacity + flat.capacity
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    c = dict(
        it=zero, transform=transform0, converged=false,
        P=torch.eye(6, device=dev).expand(B, 6, 6), degenerate=false,
        have_P=false, nan_skip=zero,
        # laserCloudOri/coeffSel append semantics as per-point outer
        # product accumulators (src/laserOdometry.cpp:458-459,580-581)
        Cacc=torch.zeros((B, N, 3, 3), device=dev),
        bacc=torch.zeros((B, N, 3), device=dev),
        n_rows=zero,
    )
    host_settled = False

    def iteration(c, corr):
        nonlocal host_settled
        transform = c["transform"]
        active = _still_active(c, can_run, cfg.odom_max_iters)
        late = c["it"] >= cfg.odom_weight_start_iter
        points, coeffs, rhs, keep = _odom_residuals(
            transform, late, sharp, flat, corner_last, surf_last, corr, cfg)
        keep = keep & active[:, None]
        coeffs = torch.where(keep[..., None], coeffs, 0.0)
        rhs = torch.where(keep, rhs, 0.0)
        n_sel = keep.sum(-1, dtype=torch.int32)
        if cfg.odom_accumulate_rows:
            Cacc = c["Cacc"] + coeffs[..., :, None] * coeffs[..., None, :]
            bacc = c["bacc"] + coeffs * (-cfg.odom_rhs_scale * rhs)[..., None]
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
        if not host_settled:
            need_P = active & enough & ~have_P
            P_new, deg_new = linalg.degeneracy_projector(
                ata, cfg.odom_degen_eigen_threshold)
            P = torch.where(need_P[:, None, None], P_new, P)
            degenerate = torch.where(need_P, deg_new, degenerate)
            have_P = have_P | need_P
            # eigh has already synced; an inactive scenario never
            # updates again and needs no projector
            host_settled = bool((have_P | ~active).all())
        x = torch.where(degenerate[:, None],
                        per_scenario(lambda p, v: p @ v, P, x), x)

        is_nan = (torch.isnan(x) | torch.isinf(x)).any(-1)
        x = torch.where(is_nan[:, None], 0.0, x)
        do_update = active & enough & ~is_nan
        new_transform = torch.where(do_update[:, None], transform + x,
                                    transform)
        delta_r = sqrt(seq_sum(torch.rad2deg(x[:, :3]) ** 2))
        delta_t = sqrt(seq_sum((x[:, 3:] * 100.0) ** 2))
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
        # the round's one host read, for the whole batch
        if not bool(_still_active(c, can_run, cfg.odom_max_iters).any()):
            break
    return c["transform"], c["nan_skip"]


def accumulate_pose(transform_sum, transform, imu: ImuTrans,
                    cfg: LoamConfig):
    """Compose the frame motion onto the global pose with the 1.05 scale
    on ry / tz, the IMU drift taken off the translation and the IMU
    rotation plug-in (src/laserOdometry.cpp:830-856); poses (6,), or
    (B, 6) with the ImuTrans's fields (B, 3) one scenario at a time
    (types.per_scenario)."""
    if transform.dim() > 1:
        return per_scenario(
            lambda s, t, i: accumulate_pose(s, t, i, cfg), transform_sum,
            transform, imu)
    neg = torch.stack([-transform[0], -transform[1] * cfg.odom_y_scale,
                       -transform[2]])
    r_new = rotations.accumulate_rotation(transform_sum[:3], neg)
    shift = imu.shift_from_start
    v = torch.stack([transform[3] - shift[0], transform[4] - shift[1],
                     transform[5] * cfg.odom_y_scale - shift[2]])
    t_new = transform_sum[3:] - rotations.r_yxz(r_new) @ v
    r_new = rotations.plugin_imu_rotation(r_new, imu.rpy_start, imu.rpy_cur)
    return torch.cat([r_new, t_new])


def _project_cloud_to_end(cloud: PointCloud, transform, cfg: LoamConfig,
                          imu: ImuTrans | None = None):
    tail = () if imu is None else (imu.rpy_start, imu.rpy_cur,
                                   imu.shift_from_start)
    xyz = transform_to_end(cloud.xyz, cloud.sweep_time(cfg.scan_period),
                           transform, *tail)
    # TransformToEnd resets the fractional sweep time (:193)
    return cloud.replace(
        xyz=torch.where(cloud.mask[..., None], xyz, 0.0),
        rel=torch.floor(cloud.rel),
    )


def odometry_step(state: OdomState, feats: FeatureClouds,
                  cfg: LoamConfig = LoamConfig(),
                  imu: ImuTrans | None = None):
    """One odometry frame (src/laserOdometry.cpp:410-931) for one
    scenario, or for B in lockstep when the state and features carry a
    leading B axis; imu is the sweep's ImuTrans (None: no IMU).  One
    scenario runs as the B=1 case of the batch.
    Returns (new_state, OdomOutput)."""
    if state.transform.dim() == 1:
        return drop_scenario_axis(_odometry_batch(
            add_scenario_axis(state), add_scenario_axis(feats), cfg,
            add_scenario_axis(imu)))
    return _odometry_batch(state, feats, cfg, imu)


def _odometry_batch(state: OdomState, feats: FeatureClouds, cfg: LoamConfig,
                    imu: ImuTrans | None):
    B = state.transform.shape[0]
    first = ~state.initialized
    # first frame: hand the clouds over, seed transformSum with the IMU
    # attitude, no solve, no pose publish (src/laserOdometry.cpp:427-456)
    tsum0 = state.transform_sum
    if imu is not None:
        r = imu.rpy_start
        tsum0 = torch.cat([tsum0[:, :1] + r[:, :1], tsum0[:, 1:2],
                           tsum0[:, 2:3] + r[:, 2:], tsum0[:, 3:]], -1)
    init_state = dataclasses.replace(
        state, corner_last=feats.less_sharp, surf_last=feats.less_flat,
        transform_sum=tsum0, initialized=torch.ones_like(state.initialized))
    init_out = OdomOutput(
        pose=tsum0, corner_last=feats.less_sharp, surf_last=feats.less_flat,
        full=feats.full,
        publish_to_mapping=torch.zeros_like(state.initialized))
    n_first = int(first.sum())
    if n_first == B:
        return init_state, init_out

    transform = state.transform
    if imu is not None:
        # IMU velocity prior on the translation (:461-463), before the
        # solvability test: an unsolved frame keeps the prior
        transform = torch.cat([transform[:, :3], transform[:, 3:]
                               - imu.velo_from_start * cfg.scan_period], -1)
    nan_skip = torch.zeros_like(state.nan_skips)
    can_solve = (~first
                 & (state.corner_last.count() > cfg.odom_min_corner_last)
                 & (state.surf_last.count() > cfg.odom_min_surf_last))
    if bool(can_solve.any()):
        transform, nan_skip = gauss_newton_odometry(
            transform, feats, state.corner_last, state.surf_last, cfg,
            can_solve)

    no_imu = ImuTrans.zeros(transform.device).map(lambda t: t.expand(B, 3))
    tsum = accumulate_pose(state.transform_sum, transform,
                           no_imu if imu is None else imu, cfg)
    corner_next = _project_cloud_to_end(feats.less_sharp, transform, cfg, imu)
    surf_next = _project_cloud_to_end(feats.less_flat, transform, cfg, imu)

    frame_count = state.frame_count + 1
    publish = frame_count >= cfg.skip_frame_num + 1
    full = feats.full
    if bool(publish.any()):
        full = where_tree(
            publish, _project_cloud_to_end(full, transform, cfg, imu), full)
    frame_count = torch.where(publish, 0, frame_count).to(torch.int32)

    new_state = OdomState(
        corner_last=corner_next, surf_last=surf_next, transform=transform,
        transform_sum=tsum, initialized=state.initialized,
        frame_count=frame_count, nan_skips=state.nan_skips + nan_skip,
    )
    out = OdomOutput(
        pose=tsum, corner_last=corner_next, surf_last=surf_next, full=full,
        publish_to_mapping=publish)
    if n_first:
        return (where_tree(first, init_state, new_state),
                where_tree(first, init_out, out))
    return new_state, out
