"""Scan-to-map refinement, strict exact-kNN path (counterpart of
loam_tpu/mapping.py; src/laserMapping.cpp:408-1096).

Every Gauss-Newton iteration re-queries the exact 5-NN through the
windowed kNN kernel (ops/cuda/knn_topk), the reference's per-iteration
kd re-query (src/laserMapping.cpp:717,824).  One host read of the
convergence flag per iteration, the JAX while_loop's own cadence.
"""

from __future__ import annotations

import dataclasses

import torch

from loam_tpu.config import LoamConfig

from . import map_store
from .ops import residuals
from .ops.cuda.knn_topk import knn_points
from .ops.voxel import voxel_downsample
from .types import PointCloud
from .utils import linalg, rotations
from .utils.numerics import seq_sum, sqrt


@dataclasses.dataclass
class MapState:
    corner_map: map_store.VoxelTable
    surf_map: map_store.VoxelTable
    transform_bef: torch.Tensor       # (6,) odometry pose at last mapping
    transform_aft: torch.Tensor       # (6,) mapped pose at last mapping
    nan_skips: torch.Tensor           # () int32
    local_map_overflow: torch.Tensor  # () int32 centroids cut by the caps

    @staticmethod
    def create(cfg: LoamConfig, device=None) -> "MapState":
        z = torch.tensor(0, dtype=torch.int32, device=device)
        return MapState(
            corner_map=map_store.VoxelTable.create(cfg.corner_table_size,
                                                   device),
            surf_map=map_store.VoxelTable.create(cfg.surf_table_size, device),
            transform_bef=torch.zeros(6, device=device),
            transform_aft=torch.zeros(6, device=device),
            nan_skips=z, local_map_overflow=z.clone(),
        )


@dataclasses.dataclass
class MapOutput:
    pose_aft: torch.Tensor
    pose_bef: torch.Tensor
    solved: torch.Tensor


def check_mapping_config(cfg: LoamConfig) -> None:
    if not cfg.map_exact_knn:
        raise NotImplementedError(
            "map_exact_knn=False (the cell-bucket mapping mode) is not "
            "ported yet (ROADMAP.md, queue 1 item 7)")
    if cfg.map_exact_regather_every > 1:
        raise NotImplementedError(
            "map_exact_regather_every > 1 (the hybrid cadence) is not "
            "ported yet (ROADMAP.md, queue 1 item 7)")


def _corner_map_residuals(nn_fn, q_body, q_mask, tobe, cfg: LoamConfig):
    """5-NN line fit and point-to-line residual
    (src/laserMapping.cpp:714-819)."""
    q = rotations.apply_pose(tobe, q_body)
    pts, d2 = nn_fn(q)
    gate = q_mask & (d2[:, cfg.map_knn - 1] < cfg.map_nn_gate_sq)
    centroid = seq_sum(pts, 1) / cfg.map_knn
    centered = pts - centroid[:, None, :]
    cov = seq_sum(centered[..., :, None] * centered[..., None, :],
                  1) / cfg.map_knn
    w, V = linalg.eigh3x3(cov)
    is_line = gate & (w[:, 0] > cfg.map_line_eigen_ratio * w[:, 1])
    v1 = V[:, 0, :]
    p1 = centroid + cfg.map_line_halflength * v1
    p2 = centroid - cfg.map_line_halflength * v1
    direction, d = residuals.point_to_line(q, p1, p2)
    s = 1.0 - cfg.map_weight_slope * d.abs()
    keep = is_line & (s > cfg.weight_keep_threshold)
    return (torch.where(keep[:, None], s[:, None] * direction, 0.0),
            torch.where(keep, s * d, 0.0), keep)


def _surf_map_residuals(nn_fn, q_body, q_mask, tobe, cfg: LoamConfig):
    """5-NN plane fit, 0.2 m validity, range-scaled weight
    (src/laserMapping.cpp:821-877)."""
    q = rotations.apply_pose(tobe, q_body)
    pts, d2 = nn_fn(q)
    gate = q_mask & (d2[:, cfg.map_knn - 1] < cfg.map_nn_gate_sq)
    normal, pd = linalg.fit_plane5(pts)
    off = (torch.einsum("qki,qi->qk", pts, normal) + pd[:, None]).abs()
    plane_valid = (off <= cfg.map_plane_tolerance).all(1)
    d = residuals.point_to_plane(q, normal, pd)
    range_fac = sqrt(sqrt(torch.clamp((q * q).sum(-1),
                                                  min=1e-12)))
    s = 1.0 - cfg.map_weight_slope * d.abs() / range_fac
    keep = gate & plane_valid & (s > cfg.weight_keep_threshold)
    return (torch.where(keep[:, None], s[:, None] * normal, 0.0),
            torch.where(keep, s * d, 0.0), keep)


def _exact_nn_fns(corner_local, surf_local, cfg: LoamConfig, n_q_corner,
                  n_q_surf):
    """Per-iteration exact k-NN against the compacted local maps, query
    blocks windowed to the gate radius on each map's sort axis."""
    window = float(cfg.map_nn_gate_sq) ** 0.5 if cfg.map_knn_prune else None

    def make(local, n_q):
        axis = local.sort_axis if cfg.map_knn_prune else None

        def nn(q):
            return knn_points(q, local.xyz, local.mask, cfg.map_knn,
                              n_q=n_q, prune_axis=axis, prune_window=window)
        return nn

    return make(corner_local, n_q_corner), make(surf_local, n_q_surf)


def _map_iteration(c, nn_c, nn_s, corner_stack, surf_stack, cfg,
                   host_have_P: bool):
    """One GN iteration with fresh rows (src/laserMapping.cpp:712-975);
    updates are masked once converged.  Returns (state, host_have_P)."""
    tobe = c["tobe"]
    active = ~c["converged"] & (c["it"] < cfg.map_max_iters)
    coeff_c, rhs_c, keep_c = _corner_map_residuals(
        nn_c, corner_stack.xyz, corner_stack.mask, tobe, cfg)
    coeff_s, rhs_s, keep_s = _surf_map_residuals(
        nn_s, surf_stack.xyz, surf_stack.mask, tobe, cfg)
    points = torch.cat([corner_stack.xyz, surf_stack.xyz])
    coeffs = torch.cat([coeff_c, coeff_s])
    rhs = torch.cat([rhs_c, rhs_s])
    keep = torch.cat([keep_c, keep_s])
    enough = keep.sum(dtype=torch.int32) >= cfg.map_min_correspondences

    rows = residuals.map_jacobian_rows(points, coeffs, tobe)
    ata, atb = residuals.normal_equations(rows, -rhs, keep)
    x = linalg.solve_sym6(ata, atb)

    P, degenerate, have_P = c["P"], c["degenerate"], c["have_P"]
    if not host_have_P:
        need_P = active & enough & ~have_P
        P_new, deg_new = linalg.degeneracy_projector(
            ata, cfg.map_degen_eigen_threshold)
        P = torch.where(need_P, P_new, P)
        degenerate = torch.where(need_P, deg_new, degenerate)
        have_P = have_P | need_P
        host_have_P = bool(have_P)  # eigh has already synced
    x = torch.where(degenerate, P @ x, x)

    is_nan = torch.isnan(x).any() | torch.isinf(x).any()
    x = torch.where(is_nan, 0.0, x)
    do_update = active & enough & ~is_nan
    new_tobe = torch.where(do_update, tobe + x, tobe)
    delta_r = sqrt((torch.rad2deg(x[:3]) ** 2).sum())
    delta_t = sqrt(((x[3:] * 100.0) ** 2).sum())
    converged = c["converged"] | (
        do_update & (delta_r < cfg.map_delta_r_break_deg)
        & (delta_t < cfg.map_delta_t_break_cm))
    act_i = active.to(torch.int32)
    return dict(
        it=c["it"] + act_i, tobe=new_tobe, converged=converged, P=P,
        degenerate=degenerate, have_P=have_P,
        nan_skip=c["nan_skip"] + (is_nan & enough).to(torch.int32) * act_i,
    ), host_have_P


def _sort_stack_axis(stack: PointCloud, pose, axis) -> PointCloud:
    """Sort a front-compacted stack by its world coordinate on `axis`
    (at `pose`), so each query block is a thin slab on the local map's
    sort axis.  A pure reordering; invalid rows key to +BIG."""
    world = rotations.apply_pose(pose, stack.xyz)
    coord = world.index_select(1, axis.reshape(1))[:, 0]
    order = torch.argsort(torch.where(stack.mask, coord, 3.0e38),
                          stable=True)
    return PointCloud(xyz=stack.xyz[order], rel=stack.rel[order],
                      mask=stack.mask[order])


def gauss_newton_mapping(tobe0, corner_index, surf_index, corner_stack,
                         surf_stack, cfg: LoamConfig):
    """<= map_max_iters full-step GN iterations, exact 5-NN re-query in
    each (src/laserMapping.cpp:710-975).  Returns (tobe, nan_skip)."""
    if cfg.map_knn_prune:
        corner_stack = _sort_stack_axis(corner_stack, tobe0,
                                        corner_index.sort_axis)
        surf_stack = _sort_stack_axis(surf_stack, tobe0,
                                      surf_index.sort_axis)
    nn_c, nn_s = _exact_nn_fns(
        corner_index, surf_index, cfg,
        corner_stack.mask.sum(dtype=torch.int32),
        surf_stack.mask.sum(dtype=torch.int32))
    dev = tobe0.device
    c = dict(
        it=torch.tensor(0, dtype=torch.int32, device=dev), tobe=tobe0,
        converged=torch.tensor(False, device=dev), P=torch.eye(6, device=dev),
        degenerate=torch.tensor(False, device=dev),
        have_P=torch.tensor(False, device=dev),
        nan_skip=torch.tensor(0, dtype=torch.int32, device=dev),
    )
    host_have_P = False
    for _ in range(cfg.map_max_iters):
        c, host_have_P = _map_iteration(c, nn_c, nn_s, corner_stack,
                                        surf_stack, cfg, host_have_P)
        if bool(c["converged"]):   # the iteration's one host sync
            break
    return c["tobe"], c["nan_skip"]


def _downsample_cloud(cloud: PointCloud, leaf, cap):
    xyz, rel, m = voxel_downsample(cloud.xyz, cloud.mask, leaf, cap,
                                   extra=cloud.rel)
    return PointCloud(xyz=xyz, rel=rel, mask=m)


def mapping_step(state: MapState, pose_sum, corner_last: PointCloud,
                 surf_last: PointCloud, cfg: LoamConfig = LoamConfig()):
    """One mapping frame (src/laserMapping.cpp:408-1096), no IMU blend.
    Returns (new_state, MapOutput)."""
    check_mapping_config(cfg)
    tobe = rotations.transform_associate_to_map(
        pose_sum, state.transform_bef, state.transform_aft)
    corner_stack = _downsample_cloud(corner_last, cfg.map_corner_leaf,
                                     cfg.max_corner_stack)
    surf_stack = _downsample_cloud(surf_last, cfg.map_surf_leaf,
                                   cfg.max_surf_stack)
    center = map_store.center_cube(tobe)
    corner_map = map_store.evict_outside_window(state.corner_map, center,
                                                cfg)
    surf_map = map_store.evict_outside_window(state.surf_map, center, cfg)

    fov = map_store.local_cube_fov(center, tobe, cfg)
    corner_index = map_store.local_map_points(
        corner_map, center, fov, cfg.max_corner_from_map, cfg)
    surf_index = map_store.local_map_points(
        surf_map, center, fov, cfg.max_surf_from_map, cfg)
    overflow = corner_index.overflow() + surf_index.overflow()

    can_solve = ((corner_index.n_local > cfg.map_min_corner_from_map)
                 & (surf_index.n_local > cfg.map_min_surf_from_map))
    nan_skip = torch.zeros_like(state.nan_skips)
    if bool(can_solve):
        tobe, nan_skip = gauss_newton_mapping(
            tobe, corner_index, surf_index, corner_stack, surf_stack, cfg)

    def insert(table, stack, leaf, cap):
        world = rotations.apply_pose(tobe, stack.xyz)
        hi, lo, sums, cnts, valid = map_store.aggregate_by_voxel(
            world, stack.mask, leaf, cap)
        return map_store.table_insert(table, hi, lo, sums, cnts, valid, cfg)

    corner_map = insert(corner_map, corner_stack, cfg.map_corner_leaf,
                        cfg.max_corner_stack)
    surf_map = insert(surf_map, surf_stack, cfg.map_surf_leaf,
                      cfg.max_surf_stack)

    new_bef = torch.where(can_solve, pose_sum, state.transform_bef)
    new_aft = torch.where(can_solve, tobe, state.transform_aft)
    new_state = MapState(
        corner_map=corner_map, surf_map=surf_map, transform_bef=new_bef,
        transform_aft=new_aft, nan_skips=state.nan_skips + nan_skip,
        local_map_overflow=state.local_map_overflow + overflow,
    )
    return new_state, MapOutput(pose_aft=new_aft, pose_bef=new_bef,
                                solved=can_solve)


def surround_cloud(state: MapState, cap: int = 65536) -> PointCloud:
    """The map visualization cloud (/laser_cloud_surround,
    src/laserMapping.cpp:1038-1058): all live centroids, compacted."""
    def extract(table, n):
        live = table.live()
        order = torch.argsort((~live).to(torch.uint8), stable=True)[:n]
        return table.centroids()[order], live[order]

    cx, cm = extract(state.corner_map, cap // 4)
    sx, sm = extract(state.surf_map, cap - cap // 4)
    xyz = torch.cat([cx, sx])
    return PointCloud(xyz=xyz, rel=torch.zeros(xyz.shape[0],
                                               device=xyz.device),
                      mask=torch.cat([cm, sm]))
