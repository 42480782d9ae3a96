"""Typed configuration of the LOAM engine (the port's own copy of
loam_tpu/config.py: the same frozen dataclass, field for field, so a
configuration converts with ``LoamConfig(**dataclasses.asdict(other))``).

Every tunable in the reference is a compile-time constant scattered through
four C++ files (see SURVEY.md §5 "Config / flag system").  Here the full
behavioral contract is a single frozen, hashable dataclass.

Reference provenance for each constant is cited inline (file:line in
the reference C++ sources).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LoamConfig:
    # ---- sensor geometry -------------------------------------------------
    # scanPeriod: src/scanRegistration.cpp:55 (0.1 s sweep == 10 Hz)
    scan_period: float = 0.1
    # N_SCANS: src/scanRegistration.cpp:61 (VLP-16)
    n_scans: int = 16
    # Static per-ring point capacity.  VLP-16 emits ~1800 azimuth steps per
    # ring at 10 Hz; the reference caps the whole cloud at 40000
    # (src/scanRegistration.cpp:63-66).  We use a padded ring-major
    # (n_scans, ring_width) layout; 2048 = 64 words of 32 bits a ring
    # for the selection walk's bit-fields.
    ring_width: int = 2048
    # systemDelay: src/scanRegistration.cpp:57 (skip first 20 sweeps).
    # The data layer applies this; the pure pipeline does not need it.
    system_delay: int = 20

    # ---- feature extraction (scanRegistration) ---------------------------
    # curvature threshold: src/scanRegistration.cpp:480,528
    curvature_threshold: float = 0.1
    # per-subregion quotas: src/scanRegistration.cpp:483,487,534
    max_sharp_per_subregion: int = 2
    max_less_sharp_per_subregion: int = 20
    max_flat_per_subregion: int = 4
    n_subregions: int = 6  # src/scanRegistration.cpp:462
    # neighbor suppression window and gap: src/scanRegistration.cpp:495-520
    suppress_neighbors: int = 5
    suppress_gap_sq: float = 0.05
    # occlusion / parallel-beam filters: src/scanRegistration.cpp:395-452
    occlusion_diff_sq: float = 0.1
    occlusion_rel_thresh: float = 0.1
    parallel_beam_frac: float = 0.0002
    # less-flat voxel leaf: src/scanRegistration.cpp:578 (0.2 m)
    less_flat_leaf: float = 0.2
    # Greedy-selection scan depth: the reference walks the full
    # curvature-sorted subregion (src/scanRegistration.cpp:477,525), and
    # already-picked/suppressed entries consume sorted ranks, so a
    # truncated scan can miss late qualifying picks.  <= 0 (default)
    # scans the whole subregion — exact; positive values trade exactness
    # for a shorter walk (the walk kernel's corner_k / flat_k).
    corner_scan_k: int = 0
    flat_scan_k: int = 0
    # Greedy-selection strategy (all three produce identical labels,
    # pinned by tests/test_select_walk.py + tests/test_select_argmax.py).
    # The port always runs the walk as its CUDA kernel
    # (csrc/select_walk.cu), whatever select_walk_kernel says, and for
    # select_argmax=True too (the same labels); select_argmax with a
    # scan depth raises ValueError, as in the JAX package.
    select_argmax: bool = False
    select_walk_kernel: bool = False

    # ---- static feature-cloud capacities ---------------------------------
    max_sharp: int = 256        # 16 rings * 6 subregions * 2 = 192
    max_flat: int = 512         # 16 * 6 * 4 = 384
    max_less_sharp: int = 2048  # 16 * 6 * 20 = 1920
    # post-0.2 m-downsample cap: a VLP-16 ring can exceed 512 occupied
    # 0.2 m voxels, and silently dropping voxels changes the odometry
    # correspondence set vs the reference
    max_less_flat: int = 16384
    # per-ring less-flat downsample output capacity
    less_flat_ring_cap: int = 1024

    # ---- scan-to-scan odometry (laserOdometry) ---------------------------
    # skipFrameNum: src/laserOdometry.cpp:51 (mapping consumes every 2nd)
    skip_frame_num: int = 1
    # iteration cap / convergence: src/laserOdometry.cpp:470,815-826
    odom_max_iters: int = 25
    odom_delta_r_break_deg: float = 0.1
    odom_delta_t_break_cm: float = 0.1
    # re-association cadence: src/laserOdometry.cpp:474 (iterCount % 5 == 0)
    reassociate_every: int = 5
    # NN gate: src/laserOdometry.cpp:481,485 (25 m^2)
    odom_nn_gate_sq: float = 25.0
    # ring window for 2nd/3rd correspondence point: +-2.5 ring IDs
    # (src/laserOdometry.cpp:487,506,599,623)
    ring_window: float = 2.5
    # robust weight: s = 1 - 1.8*|d| after iter 5, keep s > 0.1
    # (src/laserOdometry.cpp:570-571,579,680-683,690)
    odom_weight_slope: float = 1.8
    odom_weight_start_iter: int = 5
    weight_keep_threshold: float = 0.1
    # rhs scaling: src/laserOdometry.cpp:763 (matB = -0.05 * d2)
    odom_rhs_scale: float = 0.05
    # degeneracy eigenvalue threshold: src/laserOdometry.cpp:779 (10)
    odom_degen_eigen_threshold: float = 10.0
    # minimum selected correspondences: src/laserOdometry.cpp:698 (10)
    odom_min_correspondences: int = 10
    # gates on last-cloud sizes: src/laserOdometry.cpp:465,903
    odom_min_corner_last: int = 10
    odom_min_surf_last: int = 100
    # empirical ry / tz scale: src/laserOdometry.cpp:832,838 (1.05)
    odom_y_scale: float = 1.05
    # The reference clears laserCloudOri/coeffSel once per FRAME, outside
    # the 25-iteration GN loop (src/laserOdometry.cpp:458-459 vs the loop
    # at :470): every iteration APPENDS its selected correspondences, and
    # each solve runs over all rows accumulated so far (older rows keep
    # their frozen coeff/distance, src/laserOdometry.cpp:574-577,710, but
    # their Jacobians are re-evaluated at the current transform, :708-753).
    # True reproduces that accumulation via per-point coeff-outer-product
    # accumulators; False solves each iteration on fresh rows only
    # (textbook GN).
    odom_accumulate_rows: bool = True
    # The reference truncates the upward index scan for the 2nd/3rd
    # correspondence point to the *current* feature count instead of the
    # last-cloud size (src/laserOdometry.cpp:486,598 use
    # cornerPointsSharpNum/surfPointsFlatNum as the loop bound on
    # laserCloudCornerLast/laserCloudSurfLast).  True (default) emulates
    # the truncation for reference parity — exact up to within-ring
    # ordering, since both our compaction and the reference's push order
    # are ring-major; False searches the whole last cloud (correct
    # semantics, slightly better correspondences).
    emulate_upward_scan_truncation: bool = True

    # ---- scan-to-map refinement (laserMapping) ---------------------------
    # stackFrameNum / mapFrameNum: src/laserMapping.cpp:51-52
    stack_frame_num: int = 1
    map_frame_num: int = 5
    # cube grid: src/laserMapping.cpp:64-70 (21 x 11 x 21 cubes of 50 m)
    cube_size: float = 50.0
    grid_width: int = 21
    grid_height: int = 11
    grid_depth: int = 21
    # local neighborhood: 5x5x5 cubes (src/laserMapping.cpp:618-620)
    local_cubes: int = 2  # +-2 cubes around the sensor cube
    # map NN: 5-NN with 5th sq-dist < 1.0 (src/laserMapping.cpp:717-719,824-826)
    map_knn: int = 5
    map_nn_gate_sq: float = 1.0
    # corner line fit: lambda1 > 3*lambda2 (src/laserMapping.cpp:769),
    # virtual points at +-0.1*eigvec (:774-779)
    map_line_eigen_ratio: float = 3.0
    map_line_halflength: float = 0.1
    # surf plane validity: off-plane > 0.2 rejects (src/laserMapping.cpp:849)
    map_plane_tolerance: float = 0.2
    # robust weight slope 0.9 (src/laserMapping.cpp:806,863)
    map_weight_slope: float = 0.9
    # GN: <=10 iters, min 50 correspondences, converge 0.05/0.05,
    # degeneracy threshold 100 (src/laserMapping.cpp:710,887,936,972)
    map_max_iters: int = 10
    map_min_correspondences: int = 50
    map_delta_r_break_deg: float = 0.05
    map_delta_t_break_cm: float = 0.05
    map_degen_eigen_threshold: float = 100.0
    # gates on local map sizes: src/laserMapping.cpp:706
    map_min_corner_from_map: int = 10
    map_min_surf_from_map: int = 100
    # incoming stack voxel leaves: src/laserMapping.cpp:389-392 (0.2 / 0.4)
    map_corner_leaf: float = 0.2
    map_surf_leaf: float = 0.4
    # map visualization leaf: src/laserMapping.cpp:395 (0.6) -- the active
    # code path actually reuses the 0.2 corner filter for the surround
    # cloud (src/laserMapping.cpp:1050); we keep both.
    map_viz_leaf: float = 0.6
    # IMU roll/pitch blend: src/laserMapping.cpp:224-225 (0.998 / 0.002)
    imu_blend: float = 0.002

    # ---- map store (voxel-hash; replaces cube pointer array + PCL) -------
    # Global map = open-addressed hash of voxel centroids in device
    # memory, keyed by absolute voxel coordinates.  Replaces
    # laserCloudCornerArray /
    # laserCloudSurfArray (src/laserMapping.cpp:88-91) + the 6 recentering
    # while-loops (:454-614): absolute keys need no recentering at all.
    corner_table_size: int = 1 << 17
    surf_table_size: int = 1 << 18
    table_ways: int = 4        # slots per hash bucket (set-associative)
    insert_rounds: int = 4     # conflict-retry rounds per frame
    # Cap on the accumulated per-voxel point count: makes the centroid an
    # exponential moving average, approximating PCL VoxelGrid's repeated
    # re-centroiding of (old centroid + new points).
    voxel_count_cap: float = 100.0
    # per-frame local search grid (replaces the per-frame kd-trees,
    # src/laserMapping.cpp:707-708): 1 m cells, 27-cell neighborhoods
    search_cell: float = 1.0
    search_buckets: int = 1 << 14
    search_bucket_cap: int = 32
    # Exact-kNN mapping path (default): the FOV-culled local map is
    # compacted into one dense block and every GN iteration re-queries
    # exact 5-NN through the windowed distance/top-k kernel
    # (csrc/knn_topk.cu) — the reference's per-iteration kd-query
    # semantics (src/laserMapping.cpp:717,824).  False
    # selects the bounded-memory cell-bucket variant below (cached
    # candidates + drift-triggered re-gather).
    map_exact_knn: bool = True
    # Spatial tile pruning for the exact-kNN kernel: the
    # local map is sorted along its dominant-extent axis
    # (map_store.local_map_points), the query stacks are sorted the same
    # way at the motion-prior pose, and each query block then skips
    # reference tiles entirely outside its 1 m search window on that
    # axis.  Exact within the reference's 5-NN distance gate
    # (src/laserMapping.cpp:717-719,824-826): pruning can only hide
    # neighbors the gate rejects anyway (ops/cuda/knn_topk.knn_points).
    map_knn_prune: bool = True
    # Exact-kNN re-query cadence: 1 (default) = the reference's strict
    # per-iteration kd re-query (src/laserMapping.cpp:717,824); n > 1 =
    # the windowed kernel gathers each query's top-map_exact_cache_k
    # candidates once per n iterations and the iterations re-rank that
    # cache with the kselect kernel (csrc/kselect.cu).  Per-iteration GN
    # updates are millimetric while the cache spans ~2x the 1 m gate,
    # so the cached top-k stays a superset of the true gated 5-NN;
    # knn_regather_drift re-gathers mid-round on a bad motion prior.
    # Accuracy A/B: tests/test_golden_parity.py::
    # test_exact_knn_hybrid_parity holds the same 5 cm oracle gate at
    # n=5; tests/test_knn_prune.py pins hybrid-vs-strict pose agreement.
    map_exact_regather_every: int = 1
    map_exact_cache_k: int = 8
    # cached NN candidates per query (map_exact_knn=False): the 27-cell
    # gather runs once per mapping frame; GN iterations re-rank this
    # top-K cache (a superset of the gated 5-NN for millimetric
    # per-iteration pose updates)
    knn_candidates: int = 24
    # if the GN iterate drifts more than this (meters) from the pose the
    # candidates were gathered at, re-gather at the current pose — keeps
    # the cached set a superset of the true 5-NN even after a bad motion
    # prior (the reference re-queries its kd-trees every iteration,
    # src/laserMapping.cpp:717,824).  <= 0 disables.
    knn_regather_drift: float = 0.2
    # cached-candidate mode runs as re-gather ROUNDS: every
    # `map_regather_every` iterations the 27-cell candidate cache is
    # re-gathered unconditionally at the current pose, bounding cache
    # staleness to one round even with the drift trigger disabled
    map_regather_every: int = 5
    # query-axis chunk for the 27-cell candidate gather: bounds the peak
    # device-memory footprint of the (Q, 27*cap, 3) gather intermediate
    # at ~chunk*27*cap*3 words, with a loop over chunks
    knn_query_chunk: int = 2048
    # local map assembly caps (5x5x5 cube neighborhood concatenation,
    # src/laserMapping.cpp:674-679)
    max_corner_from_map: int = 32768
    max_surf_from_map: int = 65536
    # incoming stack caps after downsampling
    max_corner_stack: int = 2048
    max_surf_stack: int = 8192

    # Emit the registered full-res cloud (/velodyne_cloud_registered,
    # src/laserMapping.cpp:1060-1069) from every mapping frame.  Static
    # flag: off by default to keep replay outputs small; the CLI enables
    # it for cloud export.
    emit_registered: bool = False

    # ---- IMU (scanRegistration dead-reckoning) ---------------------------
    # imuQueLength: src/scanRegistration.cpp:70
    imu_queue_len: int = 200
    gravity: float = 9.81  # src/scanRegistration.cpp:645-647

    # ---- numerics --------------------------------------------------------
    dtype: str = "float32"

    @property
    def max_points(self) -> int:
        return self.n_scans * self.ring_width

    @property
    def grid_cubes(self) -> Tuple[int, int, int]:
        return (self.grid_width, self.grid_height, self.grid_depth)


DEFAULT_CONFIG = LoamConfig()
