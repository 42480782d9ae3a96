"""Feature extraction (counterpart of loam_tpu/ops/features.py;
src/scanRegistration.cpp:358-582), batched over frames.

Curvature keeps the reference's literal 11-tap float32 accumulation
order (near-tie curvature order drives the greedy pick).  The greedy
per-subregion selection runs as the walk of ops/cuda/select_walk: the
JAX default select_ring is a batched lax.while_loop, which eager PyTorch
cannot express without thousands of tiny launches per frame, while the
walk is exactly the sequential per-ring form a GPU thread runs well.
Its labels are identical to select_ring (tests/test_select_walk.py).
"""

from __future__ import annotations

import torch

from loam_tpu.config import LoamConfig

from ..types import FeatureClouds, PointCloud, Sweep
from ..utils.numerics import sqrt
from .compact import compact_masked
from .cuda import select_walk as SW
from .voxel import voxel_downsample

NEG_INF = float("-inf")
POS_INF = float("inf")


def _shift(a, s: int, fill):
    """Shift along the last axis right by s (s > 0) or left (s < 0),
    filling with `fill` (no wraparound)."""
    if s == 0:
        return a
    pad = torch.full(a.shape[:-1] + (abs(s),), fill, dtype=a.dtype,
                     device=a.device)
    if s > 0:
        return torch.cat([pad, a[..., :-s]], -1)
    return torch.cat([a[..., -s:], pad], -1)


def _sq3(v):
    """|v|^2 summed left to right, as XLA reduces a 3-wide axis."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def ring_curvature(xyz, n):
    """Curvature for k in [5, n-6] of each ring (src/scanRegistration.cpp:
    359-391), else 0.  xyz (..., W, 3), n (...)."""
    W = xyz.shape[-2]
    idx = torch.arange(W, device=xyz.device)

    def sh(k):
        return torch.roll(xyz, -k, dims=-2)

    acc = sh(-5)
    for k in (-4, -3, -2, -1):
        acc = acc + sh(k)
    acc = acc - 10.0 * xyz
    for k in (1, 2, 3, 4, 5):
        acc = acc + sh(k)
    c = _sq3(acc)
    valid = (idx >= 5) & (idx <= n[..., None] - 6)
    return torch.where(valid, c, 0.0), valid


def ring_gaps(xyz):
    """Squared neighbour gaps ||p_{k+1} - p_k||^2 along each row."""
    W = xyz.shape[-2]
    nxt = torch.clamp(torch.arange(W, device=xyz.device) + 1, max=W - 1)
    return _sq3(xyz[..., nxt, :] - xyz)


def ring_prefilter(xyz, n, cfg: LoamConfig):
    """Occlusion + parallel-beam rejection (src/scanRegistration.cpp:
    395-452) over the concatenated cloud: xyz (..., N, 3), n (...).
    Returns the initial "neighbour picked" mask."""
    N = xyz.shape[-2]
    idx = torch.arange(N, device=xyz.device)
    nxt = torch.clamp(idx + 1, max=N - 1)
    xyz_n = xyz[..., nxt, :]
    gap_sq = _sq3(xyz_n - xyz)
    in_loop = (idx >= 5) & (idx <= n[..., None] - 7)

    depth = sqrt(_sq3(xyz))
    depth_n = depth[..., nxt]
    big_gap = in_loop & (gap_sq > cfg.occlusion_diff_sq)

    scaled_cur = (xyz * depth_n[..., None]) / torch.clamp(
        depth, min=1e-6)[..., None]
    d_b = xyz_n - scaled_cur
    behind = big_gap & (depth > depth_n) & (
        sqrt(_sq3(d_b)) / torch.clamp(depth_n, min=1e-6)
        < cfg.occlusion_rel_thresh
    )
    scaled_nxt = (xyz_n * depth[..., None]) / torch.clamp(
        depth_n, min=1e-6)[..., None]
    d_a = scaled_nxt - xyz
    ahead = big_gap & (depth <= depth_n) & (
        sqrt(_sq3(d_a)) / torch.clamp(depth, min=1e-6)
        < cfg.occlusion_rel_thresh
    )

    picked = torch.zeros_like(behind)
    for s in range(0, 6):
        picked = picked | _shift(behind, -s, False)
    for s in range(1, 7):
        picked = picked | _shift(ahead, s, False)

    dis = _sq3(xyz)
    prev_gap = _shift(gap_sq, 1, 0.0)
    par = in_loop & (gap_sq > cfg.parallel_beam_frac * dis) & (
        prev_gap > cfg.parallel_beam_frac * dis
    )
    return picked | par, gap_sq


def _suppress_reach(gap_sq, gap_thr, n_sup):
    """Per index, how far the +-n_sup suppression wave of a pick travels
    before a gap > gap_thr (src/scanRegistration.cpp:494-520)."""
    ok = gap_sq <= gap_thr
    up = torch.zeros(gap_sq.shape, dtype=torch.int32, device=gap_sq.device)
    run = torch.ones_like(ok)
    for l in range(n_sup):
        run = run & _shift(ok, -l, False)
        up = up + run.to(torch.int32)
    ok_dn = _shift(ok, 1, False)
    down = torch.zeros_like(up)
    run = torch.ones_like(ok)
    for l in range(n_sup):
        run = run & _shift(ok_dn, l, False)
        down = down + run.to(torch.int32)
    return up, down


def walk_meta(curv, gap_sq, n, cfg: LoamConfig):
    """Pack the walk's data-independent inputs for R rings: curv/gap_sq
    (R, W), n (R,).  Returns (corner_meta, flat_meta), (R, n_sub*SUBW)
    int32, following features.select_rings_walk."""
    R, W = curv.shape
    n_sub = cfg.n_subregions
    SUBW = cfg.ring_width // n_sub + 8
    dev = curv.device
    ok_ring = n >= 12
    up_reach, down_reach = _suppress_reach(
        gap_sq, cfg.suppress_gap_sq, cfg.suppress_neighbors
    )
    js = torch.arange(n_sub, device=dev)
    nn = n.to(torch.int64)[:, None]
    sp_all = torch.div(5 * (n_sub - js) + (nn - 5) * js, n_sub,
                       rounding_mode="floor")
    ep_all = torch.div(5 * (n_sub - 1 - js) + (nn - 5) * (js + 1), n_sub,
                       rounding_mode="floor") - 1
    idx_all = sp_all[..., None] + torch.arange(SUBW, device=dev)
    idxc = idx_all.clamp(0, W - 1)
    valid = (idx_all <= ep_all[..., None]) & ok_ring[:, None, None]
    cv = torch.gather(curv, 1, idxc.reshape(R, -1)).reshape(idxc.shape)

    def walk_order(c_fill, descending):
        if descending:
            # a stable ASCENDING insertion sort walked backwards
            # (src/scanRegistration.cpp:466-477): ties visit the larger
            # index first
            rev = torch.arange(SUBW - 1, -1, -1, device=dev)
            return rev[torch.argsort(-c_fill[..., rev], dim=-1, stable=True)]
        return torch.argsort(c_fill, dim=-1, stable=True)

    def meta_for(order, qual):
        def g(a):
            return torch.gather(a, -1, order)

        ind = g(idxc)
        up = torch.gather(up_reach, 1, ind.reshape(R, -1)).reshape(ind.shape)
        dn = torch.gather(down_reach, 1, ind.reshape(R, -1)).reshape(
            ind.shape)
        # clip reaches at the ring bounds (word indices stay in range)
        up = torch.minimum(up, (W - 1) - ind)
        dn = torch.minimum(dn, ind)
        return SW.pack_walk_meta(ind, g(valid), g(qual), up, dn).reshape(
            R, n_sub * SUBW)

    c_desc = torch.where(valid, cv, NEG_INF)
    corner = meta_for(walk_order(c_desc, True), cv > cfg.curvature_threshold)
    c_asc = torch.where(valid, cv, POS_INF)
    flat = meta_for(walk_order(c_asc, False), cv < cfg.curvature_threshold)
    return corner, flat


def select_rings(curv, gap_sq, pre_picked, n, cfg: LoamConfig):
    """Greedy labels for R rings through the selection walk: curv/gap_sq
    (R, W), pre_picked (R, W) bool, n (R,).  Returns (labels (R, W) int8,
    picked (R, W) bool): 2 sharp, 1 less-sharp, -1 flat, 0 other."""
    W = curv.shape[-1]
    corner, flat = walk_meta(curv, gap_sq, n, cfg)
    s_bits, l_bits, f_bits, p_bits = SW.select_walk(
        corner[None], flat[None], SW.pack_bits(pre_picked)[None],
        n_sub=cfg.n_subregions, subw=cfg.ring_width // cfg.n_subregions + 8,
        W=W, max_sharp=cfg.max_sharp_per_subregion,
        max_less_sharp=cfg.max_less_sharp_per_subregion,
        max_flat=cfg.max_flat_per_subregion,
    )
    sharp = SW.unpack_bits(s_bits[0], W)
    less = SW.unpack_bits(l_bits[0], W)
    flat_m = SW.unpack_bits(f_bits[0], W)
    labels = torch.zeros(sharp.shape, dtype=torch.int8, device=curv.device)
    labels = torch.where(flat_m, -1, labels)
    labels = torch.where(less, 1, labels)
    labels = torch.where(sharp, 2, labels).to(torch.int8)
    return labels, SW.unpack_bits(p_bits[0], W)


def _compact(xyz, rel, mask, cap):
    """Stable compaction of masked points into a fixed-capacity cloud."""
    (x, y, z, r), ok = compact_masked(
        mask, (xyz[..., 0], xyz[..., 1], xyz[..., 2], rel), cap
    )
    return PointCloud(
        xyz=torch.where(ok[..., None], torch.stack([x, y, z], -1), 0.0),
        rel=torch.where(ok, r, 0.0),
        mask=ok,
    )


def check_selection_config(cfg: LoamConfig) -> None:
    """The port runs one selection formulation: the full walk."""
    if cfg.select_argmax:
        raise NotImplementedError(
            "select_argmax is not ported yet (ROADMAP.md, queue 1 item 9: "
            "features.select_rings_argmax)")
    if cfg.corner_scan_k > 0 or cfg.flat_scan_k > 0:
        raise NotImplementedError(
            "corner_scan_k/flat_scan_k walk truncation is not ported yet "
            "(ROADMAP.md, queue 1 item 9: the remaining alternatives)")
    if cfg.ring_width > 2048 or cfg.ring_width % 32:
        raise ValueError("the selection walk packs ring indices in 11 bits "
                         "and bit-fields in 32-bit words: ring_width must "
                         "be a multiple of 32 and at most 2048")


def selection_inputs(sweep: Sweep, cfg: LoamConfig):
    """Per-ring inputs of the greedy selection: (curv, gap_sq,
    pre_picked, counts) for sweep.xyz (..., n_scans, W, 3)."""
    lead = sweep.mask.shape[:-2]
    n_scans, W = sweep.mask.shape[-2:]
    counts = sweep.mask.sum(-1, dtype=torch.int32)            # (..., S)
    curv, _ = ring_curvature(sweep.xyz, counts)

    # occlusion/parallel-beam prefilter over the CONCATENATED cloud,
    # marks bleeding across ring boundaries as in the reference
    flat_mask0 = sweep.mask.reshape(lead + (-1,))
    flat_xyz0 = sweep.xyz.reshape(lead + (-1, 3))
    (cx, cy, cz), ok0 = compact_masked(
        flat_mask0, (flat_xyz0[..., 0], flat_xyz0[..., 1], flat_xyz0[..., 2]),
        n_scans * W,
    )
    xyz_c = torch.where(ok0[..., None], torch.stack([cx, cy, cz], -1), 0.0)
    n_total = flat_mask0.sum(-1, dtype=torch.int32)
    picked_c, _ = ring_prefilter(xyz_c, n_total, cfg)
    ring_starts = torch.cumsum(counts, -1) - counts
    gather_idx = (ring_starts[..., None]
                  + torch.arange(W, device=counts.device)).clamp(
                      0, n_scans * W - 1)
    pre_picked = torch.gather(
        picked_c, -1, gather_idx.reshape(lead + (-1,)).long()
    ).reshape(sweep.mask.shape) & sweep.mask
    return curv, ring_gaps(sweep.xyz), pre_picked, counts


def extract_features(sweep: Sweep, cfg: LoamConfig = LoamConfig()
                     ) -> FeatureClouds:
    """Feature extraction over ring-organized sweeps with leading frame
    axes: sweep.xyz (..., n_scans, W, 3).  One walk launch covers every
    ring of every frame."""
    check_selection_config(cfg)
    lead = sweep.mask.shape[:-2]
    W = sweep.mask.shape[-1]
    curv, gap_sq, pre_picked, counts = selection_inputs(sweep, cfg)
    labels, _ = select_rings(
        curv.reshape(-1, W), gap_sq.reshape(-1, W),
        pre_picked.reshape(-1, W), counts.reshape(-1), cfg,
    )
    labels = labels.reshape(sweep.mask.shape)

    idx = torch.arange(W, device=counts.device)
    selectable = (idx >= 5) & (idx <= counts[..., None] - 6) & sweep.mask

    flat_xyz = sweep.xyz.reshape(lead + (-1, 3))
    flat_rel = sweep.rel.reshape(lead + (-1,))
    lab = labels.reshape(lead + (-1,))
    sharp = _compact(flat_xyz, flat_rel, lab == 2, cfg.max_sharp)
    less_sharp = _compact(flat_xyz, flat_rel, lab >= 1, cfg.max_less_sharp)
    flat = _compact(flat_xyz, flat_rel, lab == -1, cfg.max_flat)

    # less-flat: selectable points with label <= 0, 0.2 m voxel
    # downsampled per ring (src/scanRegistration.cpp:568-581)
    lf_xyz, lf_rel, lf_m = voxel_downsample(
        sweep.xyz, selectable & (labels <= 0), cfg.less_flat_leaf,
        cfg.less_flat_ring_cap, extra=sweep.rel,
    )
    less_flat = _compact(
        lf_xyz.reshape(lead + (-1, 3)), lf_rel.reshape(lead + (-1,)),
        lf_m.reshape(lead + (-1,)), cfg.max_less_flat,
    )
    return FeatureClouds(
        sharp=sharp, less_sharp=less_sharp, flat=flat, less_flat=less_flat,
        full=sweep.flatten(),
    )
