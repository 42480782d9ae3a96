"""Scan-to-map refinement (counterpart of loam_tpu/mapping.py;
src/laserMapping.cpp:408-1096), in the JAX package's three modes:

* strict (default): every Gauss-Newton iteration re-queries the exact
  5-NN through the windowed kNN kernel (ops/cuda/knn_topk), the
  reference's per-iteration kd re-query (src/laserMapping.cpp:717,824);
  one host read of the convergence flag per iteration.
* hybrid cadence (map_exact_regather_every > 1): the windowed kernel
  gathers each query's top map_exact_cache_k candidates once per round
  and the round's iterations re-rank that cache with the kselect kernel.
* cell-bucket map (map_exact_knn=False): the same rounds over the
  27-cell candidates of the per-frame search grid.

The two cached-candidate modes run as fixed-trip rounds of masked
iterations: the convergence flags are read on the host once per round,
and the drift test (knn_regather_drift) once per iteration after a
round's first.

The core runs a batch of B scenarios in lockstep (a leading axis on
every state tensor); an unbatched state is its B=1 case.  Each host
read covers the whole batch: a scenario that has converged, or cannot
solve, is frozen by its `active` mask, and a drift re-gather gathers
for every scenario and keeps the new cache only where the scenario
drifted, which is what vmap of the JAX loops computes.
"""

from __future__ import annotations

import dataclasses

import torch

from . import map_store, resolve_device
from .config import LoamConfig
from .ops import residuals
from .ops.cuda.knn_topk import MAX_K as KNN_MAX_K, knn_points
from .ops.cuda.kselect import MAX_C as KSELECT_MAX_C
from .ops.voxel import voxel_downsample
from .types import (PointCloud, add_scenario_axis, drop_scenario_axis,
                    per_scenario)
from .utils import linalg, rotations
from .utils.numerics import seq_sum, sqrt


@dataclasses.dataclass
class MapState:
    """Shapes for one scenario; a batch puts a leading B on each."""

    corner_map: map_store.VoxelTable
    surf_map: map_store.VoxelTable
    transform_bef: torch.Tensor       # (6,) odometry pose at last mapping
    transform_aft: torch.Tensor       # (6,) mapped pose at last mapping
    nan_skips: torch.Tensor           # () int32
    local_map_overflow: torch.Tensor  # () int32 centroids cut by the caps

    @staticmethod
    def create(cfg: LoamConfig, device=None,
               batch: int | None = None) -> "MapState":
        """device: None is the CUDA device (raises without one); batch:
        None for one scenario, B for a leading scenario axis."""
        device = resolve_device(device)
        lead = () if batch is None else (batch,)
        z = torch.zeros(lead, dtype=torch.int32, device=device)
        return MapState(
            corner_map=map_store.VoxelTable.create(cfg.corner_table_size,
                                                   device, batch),
            surf_map=map_store.VoxelTable.create(cfg.surf_table_size, device,
                                                 batch),
            transform_bef=torch.zeros(lead + (6,), device=device),
            transform_aft=torch.zeros(lead + (6,), device=device),
            nan_skips=z, local_map_overflow=z.clone(),
        )


@dataclasses.dataclass
class MapOutput:
    pose_aft: torch.Tensor
    pose_bef: torch.Tensor
    solved: torch.Tensor
    # /velodyne_cloud_registered (given `full` only): the full-res sweep
    # in the map frame, masked points zeroed
    registered: PointCloud | None = None


def _hybrid(cfg: LoamConfig) -> bool:
    return cfg.map_exact_knn and cfg.map_exact_regather_every > 1


def check_mapping_config(cfg: LoamConfig) -> None:
    """Refuse, before any work and on every device, what the neighbour
    kernels of the card cannot take: an exact k-NN past the kernel's
    MAX_K (csrc/knn_topk.cu's widest warp queue), and a cell-path
    selection with k > C (loam_tpu's lax.top_k refuses it too) or C past
    the kernel's MAX_C (csrc/kselect.cu)."""
    def exact(k, what):
        if not 1 <= k <= KNN_MAX_K:
            raise ValueError(
                f"{what}: the exact k-NN (csrc/knn_topk.cu) takes 1 <= k <= "
                f"{KNN_MAX_K}, its widest warp queue (32 pairs in each "
                "lane's registers)")

    def select(k, C, what):
        if not 1 <= k <= C <= KSELECT_MAX_C:
            raise ValueError(
                f"{what}: the cell-bucket map's selection (csrc/kselect.cu) "
                f"needs 1 <= k <= C <= {KSELECT_MAX_C}")

    if _hybrid(cfg):
        exact(max(cfg.map_exact_cache_k, cfg.map_knn),
              f"map_exact_cache_k={cfg.map_exact_cache_k} (with map_knn="
              f"{cfg.map_knn}): the hybrid gather's max(map_exact_cache_k, "
              "map_knn)")
    elif cfg.map_exact_knn:
        exact(cfg.map_knn, f"map_knn={cfg.map_knn} on the strict exact path")
    else:
        C = 27 * cfg.search_bucket_cap
        select(cfg.knn_candidates, C,
               f"knn_candidates={cfg.knn_candidates} from 27 * "
               f"search_bucket_cap = C={C} candidates")
        select(cfg.map_knn, cfg.knn_candidates,
               f"map_knn={cfg.map_knn} from C=knn_candidates="
               f"{cfg.knn_candidates} candidates")


def _corner_map_residuals(nn_fn, q_body, q_mask, tobe, cfg: LoamConfig):
    """5-NN line fit and point-to-line residual
    (src/laserMapping.cpp:714-819)."""
    q = rotations.apply_pose(tobe, q_body)
    pts, d2 = nn_fn(q)
    gate = q_mask & (d2[..., cfg.map_knn - 1] < cfg.map_nn_gate_sq)
    centroid = seq_sum(pts, -2) / cfg.map_knn
    centered = pts - centroid[..., None, :]
    cov = seq_sum(centered[..., :, None] * centered[..., None, :],
                  -3) / cfg.map_knn
    w, V = linalg.eigh3x3(cov)
    is_line = gate & (w[..., 0] > cfg.map_line_eigen_ratio * w[..., 1])
    v1 = V[..., 0, :]
    p1 = centroid + cfg.map_line_halflength * v1
    p2 = centroid - cfg.map_line_halflength * v1
    direction, d = residuals.point_to_line(q, p1, p2)
    s = 1.0 - cfg.map_weight_slope * d.abs()
    keep = is_line & (s > cfg.weight_keep_threshold)
    return (torch.where(keep[..., None], s[..., None] * direction, 0.0),
            torch.where(keep, s * d, 0.0), keep)


def _surf_map_residuals(nn_fn, q_body, q_mask, tobe, cfg: LoamConfig):
    """5-NN plane fit, 0.2 m validity, range-scaled weight
    (src/laserMapping.cpp:821-877)."""
    q = rotations.apply_pose(tobe, q_body)
    pts, d2 = nn_fn(q)
    gate = q_mask & (d2[..., cfg.map_knn - 1] < cfg.map_nn_gate_sq)
    normal, pd = linalg.fit_plane5(pts)
    off = (torch.einsum("...ki,...i->...k", pts, normal)
           + pd[..., None]).abs()
    plane_valid = (off <= cfg.map_plane_tolerance).all(-1)
    d = residuals.point_to_plane(q, normal, pd)
    range_fac = sqrt(sqrt(torch.clamp((q * q).sum(-1),
                                                  min=1e-12)))
    s = 1.0 - cfg.map_weight_slope * d.abs() / range_fac
    keep = gate & plane_valid & (s > cfg.weight_keep_threshold)
    return (torch.where(keep[..., None], s[..., None] * normal, 0.0),
            torch.where(keep, s * d, 0.0), keep)


def _exact_nn_fns(corner_local, surf_local, cfg: LoamConfig, n_q_corner,
                  n_q_surf, k: int | None = None):
    """Exact k-NN against the compacted local maps, query blocks windowed
    to the gate radius on each map's sort axis.  The window doubles when
    k > map_knn (the hybrid candidate gather): cached neighbours up to
    twice the gate still take part in later re-rank iterations."""
    if k is None:
        k = cfg.map_knn
    window = None
    if cfg.map_knn_prune:
        window = float(cfg.map_nn_gate_sq) ** 0.5
        if k > cfg.map_knn:
            window *= 2.0

    def make(local, n_q):
        axis = local.sort_axis if cfg.map_knn_prune else None

        def nn(q):
            return knn_points(q, local.xyz, local.mask, k, n_q=n_q,
                              prune_axis=axis, prune_window=window)
        return nn

    return make(corner_local, n_q_corner), make(surf_local, n_q_surf)


def _still_active(c, can_run, cfg: LoamConfig):
    return can_run & ~c["converged"] & (c["it"] < cfg.map_max_iters)


def _map_iteration(c, nn_c, nn_s, corner_stack, surf_stack, cfg, can_run,
                   host_settled: bool):
    """One GN iteration with fresh rows (src/laserMapping.cpp:712-975)
    for the batch; each scenario's update is masked once it has
    converged (or where it cannot solve).  Returns (state,
    host_settled)."""
    tobe = c["tobe"]
    active = _still_active(c, can_run, cfg)
    coeff_c, rhs_c, keep_c = _corner_map_residuals(
        nn_c, corner_stack.xyz, corner_stack.mask, tobe, cfg)
    coeff_s, rhs_s, keep_s = _surf_map_residuals(
        nn_s, surf_stack.xyz, surf_stack.mask, tobe, cfg)
    points = torch.cat([corner_stack.xyz, surf_stack.xyz], 1)
    coeffs = torch.cat([coeff_c, coeff_s], 1)
    rhs = torch.cat([rhs_c, rhs_s], 1)
    keep = torch.cat([keep_c, keep_s], 1)
    enough = keep.sum(-1, dtype=torch.int32) >= cfg.map_min_correspondences

    rows = residuals.map_jacobian_rows(points, coeffs, tobe)
    ata, atb = residuals.normal_equations(rows, -rhs, keep)
    x = linalg.solve_sym6(ata, atb)

    P, degenerate, have_P = c["P"], c["degenerate"], c["have_P"]
    if not host_settled:
        need_P = active & enough & ~have_P
        P_new, deg_new = linalg.degeneracy_projector(
            ata, cfg.map_degen_eigen_threshold)
        P = torch.where(need_P[:, None, None], P_new, P)
        degenerate = torch.where(need_P, deg_new, degenerate)
        have_P = have_P | need_P
        # eigh has already synced; an inactive scenario never updates
        # again and needs no projector
        host_settled = bool((have_P | ~active).all())
    x = torch.where(degenerate[:, None],
                    per_scenario(lambda p, v: p @ v, P, x), x)

    is_nan = (torch.isnan(x) | torch.isinf(x)).any(-1)
    x = torch.where(is_nan[:, None], 0.0, x)
    do_update = active & enough & ~is_nan
    new_tobe = torch.where(do_update[:, None], tobe + x, tobe)
    delta_r = sqrt(seq_sum(torch.rad2deg(x[:, :3]) ** 2))
    delta_t = sqrt(seq_sum((x[:, 3:] * 100.0) ** 2))
    converged = c["converged"] | (
        do_update & (delta_r < cfg.map_delta_r_break_deg)
        & (delta_t < cfg.map_delta_t_break_cm))
    act_i = active.to(torch.int32)
    return dict(
        it=c["it"] + act_i, tobe=new_tobe, converged=converged, P=P,
        degenerate=degenerate, have_P=have_P,
        nan_skip=c["nan_skip"] + (is_nan & enough).to(torch.int32) * act_i,
    ), host_settled


def _sort_stack_axis(stack: PointCloud, pose, axis) -> PointCloud:
    """Sort each scenario's front-compacted stack by its world
    coordinate on that scenario's `axis` (at `pose`), so each query
    block is a thin slab on the local map's sort axis.  A pure
    reordering; invalid rows key to +BIG."""
    world = rotations.apply_pose(pose, stack.xyz)
    coord = torch.gather(world, 2, axis[:, None, None].expand(
        world.shape[:2] + (1,)))[..., 0]
    order = torch.argsort(torch.where(stack.mask, coord, 3.0e38), dim=-1,
                          stable=True)
    return PointCloud(xyz=map_store._take(stack.xyz, order),
                      rel=torch.gather(stack.rel, -1, order),
                      mask=torch.gather(stack.mask, -1, order))


def _rounds_loop(c, gather, every: int, corner_stack, surf_stack,
                 cfg: LoamConfig, can_run):
    """Cached-candidate GN rounds (loam_tpu mapping.rounds_loop): gather
    once per round at the current poses, then `every` masked iterations
    re-ranking that cache.  Inside a round the drift test re-gathers at
    the current pose for a scenario whose iterate has moved more than
    cfg.knn_regather_drift from its gather pose (a bad motion prior):
    the batch gathers at every current pose and keeps the new cache
    and gather pose only where the scenario drifted.  A round's first
    iteration has drift exactly 0 and never re-gathers.  Host reads:
    the drift test per later iteration, `converged` once per round,
    each for the whole batch."""
    host_settled = False
    for _ in range(-(-cfg.map_max_iters // every)):
        gather_pose = c["tobe"]
        cache = gather(gather_pose)
        for i in range(every):
            if i > 0 and cfg.knn_regather_drift > 0:
                step = c["tobe"][:, 3:] - gather_pose[:, 3:]
                drifted = sqrt(seq_sum(step * step)) > cfg.knn_regather_drift
                if bool(drifted.any()):
                    fresh = gather(c["tobe"])
                    gather_pose = torch.where(drifted[:, None], c["tobe"],
                                              gather_pose)
                    cache = tuple(torch.where(
                        drifted.reshape((-1,) + (1,) * (new.dim() - 1)),
                        new, old) for new, old in zip(fresh, cache))
            cand_c, valid_c, cand_s, valid_s = cache
            c, host_settled = _map_iteration(
                c,
                lambda q: map_store.knn_from_candidates(cand_c, valid_c, q,
                                                        cfg.map_knn),
                lambda q: map_store.knn_from_candidates(cand_s, valid_s, q,
                                                        cfg.map_knn),
                corner_stack, surf_stack, cfg, can_run, host_settled)
        if not bool(_still_active(c, can_run, cfg).any()):
            break
    return c["tobe"], c["nan_skip"]


def gauss_newton_mapping(tobe0, corner_index, surf_index, corner_stack,
                         surf_stack, cfg: LoamConfig, can_run):
    """<= map_max_iters full-step GN iterations with per-iteration
    re-association (src/laserMapping.cpp:710-975) for B scenarios in
    lockstep: tobe0 (B, 6), can_run (B,) bool the scenarios that solve;
    the others keep tobe0.  With cfg.map_exact_knn the
    indices are map_store.LocalMap blocks (strict per-iteration exact
    5-NN, or the hybrid rounds); otherwise map_store.SearchGrid bucket
    grids (cell-bucket rounds).  Returns (tobe, nan_skip)."""
    B = tobe0.shape[0]
    dev = tobe0.device
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    c = dict(
        it=zero, tobe=tobe0, converged=false,
        P=torch.eye(6, device=dev).expand(B, 6, 6), degenerate=false,
        have_P=false, nan_skip=zero,
    )
    if not cfg.map_exact_knn:
        def gather_cells(pose):
            cand_c, valid_c = map_store.knn_candidates(
                corner_index, rotations.apply_pose(pose, corner_stack.xyz),
                corner_stack.mask, cfg.knn_candidates, cfg)
            cand_s, valid_s = map_store.knn_candidates(
                surf_index, rotations.apply_pose(pose, surf_stack.xyz),
                surf_stack.mask, cfg.knn_candidates, cfg)
            return cand_c, valid_c, cand_s, valid_s

        return _rounds_loop(c, gather_cells, max(1, cfg.map_regather_every),
                            corner_stack, surf_stack, cfg, can_run)

    if cfg.map_knn_prune:
        # query blocks become thin slabs on the map's sort axis at the
        # motion-prior pose
        corner_stack = _sort_stack_axis(corner_stack, tobe0,
                                        corner_index.sort_axis)
        surf_stack = _sort_stack_axis(surf_stack, tobe0,
                                      surf_index.sort_axis)
    n_qc = corner_stack.mask.sum(-1, dtype=torch.int32)
    n_qs = surf_stack.mask.sum(-1, dtype=torch.int32)

    if _hybrid(cfg):
        nn_cg, nn_sg = _exact_nn_fns(
            corner_index, surf_index, cfg, n_qc, n_qs,
            k=max(cfg.map_exact_cache_k, cfg.map_knn))

        def gather_exact(pose):
            cand_c, d2c = nn_cg(rotations.apply_pose(pose, corner_stack.xyz))
            cand_s, d2s = nn_sg(rotations.apply_pose(pose, surf_stack.xyz))
            return cand_c, d2c < 1e28, cand_s, d2s < 1e28

        return _rounds_loop(c, gather_exact, cfg.map_exact_regather_every,
                            corner_stack, surf_stack, cfg, can_run)

    # strict reference semantics: exact 5-NN re-query every iteration
    nn_c, nn_s = _exact_nn_fns(corner_index, surf_index, cfg, n_qc, n_qs)
    host_settled = False
    for _ in range(cfg.map_max_iters):
        c, host_settled = _map_iteration(c, nn_c, nn_s, corner_stack,
                                         surf_stack, cfg, can_run,
                                         host_settled)
        # the iteration's one host read, for the whole batch
        if not bool(_still_active(c, can_run, cfg).any()):
            break
    return c["tobe"], c["nan_skip"]


def _downsample_cloud(cloud: PointCloud, leaf, cap):
    xyz, rel, m = voxel_downsample(cloud.xyz, cloud.mask, leaf, cap,
                                   extra=cloud.rel)
    return PointCloud(xyz=xyz, rel=rel, mask=m)


def mapping_step(state: MapState, pose_sum, corner_last: PointCloud,
                 surf_last: PointCloud, cfg: LoamConfig = LoamConfig(),
                 imu_rpy=None, full: PointCloud | None = None):
    """One mapping frame (src/laserMapping.cpp:408-1096) for one
    scenario, or for B in lockstep when the state, pose and clouds carry
    a leading B axis.  One scenario runs as the B=1 case of the batch.

    imu_rpy: None, or (3,) [pitch, roll, ok] of the IMU at the sweep-end
    time t_scan + scanPeriod (src/laserMapping.cpp:203-222) for the
    0.998/0.002 roll/pitch blend of transformUpdate; ok > 0.5 is the
    reference's imuPointerLast >= 0 guard.
    full: None, or the odometry's end-projected full cloud; then
    MapOutput.registered is that cloud moved into the map frame with the
    refined pose (src/laserMapping.cpp:1060-1069).
    Returns (new_state, MapOutput)."""
    if state.transform_aft.dim() == 1:
        one = add_scenario_axis
        return drop_scenario_axis(_mapping_batch(
            one(state), pose_sum[None], one(corner_last), one(surf_last),
            cfg, None if imu_rpy is None else imu_rpy[None], one(full)))
    return _mapping_batch(state, pose_sum, corner_last, surf_last, cfg,
                          imu_rpy, full)


def _mapping_batch(state: MapState, pose_sum, corner_last: PointCloud,
                   surf_last: PointCloud, cfg: LoamConfig, imu_rpy,
                   full: PointCloud | None = None):
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
    if cfg.map_exact_knn:
        corner_index = map_store.local_map_points(
            corner_map, center, fov, cfg.max_corner_from_map, cfg)
        surf_index = map_store.local_map_points(
            surf_map, center, fov, cfg.max_surf_from_map, cfg)
        overflow = corner_index.overflow() + surf_index.overflow()
    else:
        corner_index = map_store.build_search_grid(corner_map, center, fov,
                                                   cfg)
        surf_index = map_store.build_search_grid(surf_map, center, fov, cfg)
        overflow = torch.zeros_like(state.local_map_overflow)

    can_solve = ((corner_index.n_local > cfg.map_min_corner_from_map)
                 & (surf_index.n_local > cfg.map_min_surf_from_map))
    nan_skip = torch.zeros_like(state.nan_skips)
    if bool(can_solve.any()):
        tobe, nan_skip = gauss_newton_mapping(
            tobe, corner_index, surf_index, corner_stack, surf_stack, cfg,
            can_solve)

    # transformUpdate runs only on a frame that could solve
    # (src/laserMapping.cpp:706,977-978): elsewhere no blend, and bef/aft
    # keep their old values below, while insertion uses the prior pose
    if imu_rpy is not None:
        keep = 1.0 - cfg.imu_blend
        blended = torch.stack([
            keep * tobe[:, 0] + cfg.imu_blend * imu_rpy[:, 0], tobe[:, 1],
            keep * tobe[:, 2] + cfg.imu_blend * imu_rpy[:, 1]], -1)
        tobe = torch.where((can_solve & (imu_rpy[:, 2] > 0.5))[:, None],
                           torch.cat([blended, tobe[:, 3:]], -1), tobe)

    def insert(table, stack, leaf, cap):
        world = rotations.apply_pose(tobe, stack.xyz)
        hi, lo, sums, cnts, valid = map_store.aggregate_by_voxel(
            world, stack.mask, leaf, cap)
        return map_store.table_insert(table, hi, lo, sums, cnts, valid, cfg)

    corner_map = insert(corner_map, corner_stack, cfg.map_corner_leaf,
                        cfg.max_corner_stack)
    surf_map = insert(surf_map, surf_stack, cfg.map_surf_leaf,
                      cfg.max_surf_stack)

    # registered full-res cloud (src/laserMapping.cpp:1060-1069), one
    # scenario at a time so that it rounds as that scenario's single
    # replay does
    registered = None
    if full is not None:
        reg_xyz = per_scenario(rotations.apply_pose, tobe, full.xyz)
        registered = full.replace(
            xyz=torch.where(full.mask[..., None], reg_xyz, 0.0))

    new_bef = torch.where(can_solve[:, None], pose_sum, state.transform_bef)
    new_aft = torch.where(can_solve[:, None], tobe, state.transform_aft)
    new_state = MapState(
        corner_map=corner_map, surf_map=surf_map, transform_bef=new_bef,
        transform_aft=new_aft, nan_skips=state.nan_skips + nan_skip,
        local_map_overflow=state.local_map_overflow + overflow,
    )
    return new_state, MapOutput(pose_aft=new_aft, pose_bef=new_bef,
                                solved=can_solve, registered=registered)


def surround_cloud(state: MapState, cap: int = 65536) -> PointCloud:
    """The map visualization cloud (/laser_cloud_surround,
    src/laserMapping.cpp:1038-1058) of one scenario's map: all live
    centroids, compacted."""
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
