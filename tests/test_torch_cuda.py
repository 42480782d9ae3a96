"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and the CUDA toolkit; elsewhere they skip.
They import no JAX, so on a machine without it run them as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Each kernel runs through its public wrapper on CUDA tensors with a batch
of two problems of different live sizes (the launch's blockIdx.y axis),
and must equal the plain version on the same tensors: indices and
bit-fields identical, squared distances identical (both compute the
same IEEE sequence round(round(dx^2 + dy^2) + dz^2)).
"""

import dataclasses

import numpy as np
import pytest
import torch

from loam_tpu_torch.config import LoamConfig
from loam_tpu_torch.ops.cuda import knn_topk as KN
from loam_tpu_torch.ops.cuda import kselect as KS
from loam_tpu_torch.ops.cuda import odom_corr as OC
from loam_tpu_torch.ops.cuda import select_walk as SW

from torch_parity import (kselect_argsort, kselect_lattice_case,
                          walk_kwargs, walk_meta_case, windowed_knn_case,
                          windowed_knn_scalar)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _i32(values, dev):
    return torch.tensor(values, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    B, Q, M, tq, tm = 2, 512, 2048, 128, 256
    ref = torch.tensor(rng.uniform(-4, 4, (B, M, 3)), dtype=torch.float32,
                       device=cuda)
    q = (ref[:, rng.integers(0, 1000, Q)]
         + torch.tensor(rng.normal(0, 0.2, (B, Q, 3)), device=cuda)).float()
    n_q, n_ref = _i32([300, Q], cuda), _i32([1000, 1700], cuda)
    nqb = Q // tq
    t_lo = _i32(rng.integers(0, 3, (B, nqb)), cuda)
    t_hi = _i32(rng.integers(4, M // tm + 1, (B, nqb)), cuda)
    before = KN.knn_topk_dyn.launches
    idx, d2 = KN.knn_topk_dyn(q, ref, n_q, n_ref, k, t_lo, t_hi, tq=tq, tm=tm)
    assert KN.knn_topk_dyn.launches == before + 1
    idx_p, d2_p = KN.knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                                    tq=tq, tm=tm)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    assert (d2[0, 384:] > 1e28).all()          # dead query blocks
    before = KN.knn_topk.launches
    idx, d2 = KN.knn_topk(q, ref, n_ref, k, tq=tq, tm=tm)
    assert KN.knn_topk.launches == before + 1
    full_lo, full_hi = KN.full_windows(B, Q, M, tq, tm, cuda)
    idx_p, d2_p = KN.knn_topk_plain(q, ref, _i32([Q, Q], cuda), n_ref, k,
                                    full_lo, full_hi, tq=tq, tm=tm)
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)


@pytest.mark.parametrize("tq,tm", [(8, 16), (64, 6), (256, 64), (40, 10)])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_windowed_kernel_ties_and_windows(cuda, k, tq, tm):
    """The warp-a-query kernel on lattice clouds (exact ties in every
    row) equals the plain version and the row-at-a-time reference bit for
    bit: three problems of different live sizes, rows past n_q in a live
    block, a block with fewer than K visible references, an empty window,
    clamped windows, dead blocks, no live reference; windows that start
    16-byte aligned and not (tm = 6, 10), and a tq that leaves warps of
    the last block spare (40)."""
    case = windowed_knn_case(tq, tm, seed=k)
    q, ref, n_q, n_ref, t_lo, t_hi = (torch.tensor(a, device=cuda)
                                      for a in case)
    before = KN.knn_topk_dyn.launches
    idx, d2 = KN.knn_topk_dyn(q, ref, n_q, n_ref, k, t_lo, t_hi, tq=tq, tm=tm)
    assert KN.knn_topk_dyn.launches == before + 1
    idx_p, d2_p = KN.knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                                    tq=tq, tm=tm)
    torch.cuda.synchronize()
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    want_idx, want_d2 = windowed_knn_scalar(*case, k, tq, tm)
    np.testing.assert_array_equal(idx.cpu().numpy(), want_idx)
    np.testing.assert_array_equal(d2.cpu().numpy(), want_d2)
    assert (d2[0, tq:2 * tq] < 1e29).sum() == min(k, 3) * tq
    assert (d2[1] == 1e30).all() and (idx[1] == 0).all()


@pytest.mark.parametrize("k,margin", [(5, 1.0), (8, 2.0)])
def test_knn_windowed_kernel_replay_shapes(cuda, k, margin):
    """The mapping shapes (8192 queries against a 65536-point map, tile
    windows from the sorted pruning axis), a surf-sized and a corner-sized
    problem in one launch."""
    rng = np.random.default_rng(k)
    B, Q, M, tq, tm = 2, 8192, 65536, 256, 512
    live = ((6000, 50000), (1500, 25000))
    qp, refp = np.zeros((B, Q, 3), np.float32), np.zeros((B, M, 3), np.float32)
    half = np.array([60.0, 20.0, 5.0])
    for b, (nq, nr) in enumerate(live):
        r = rng.uniform(-half, half, (nr, 3)).astype(np.float32)
        refp[b, :nr] = r[np.argsort(r[:, 0], kind="stable")]
        p = r[rng.integers(0, nr, nq)] + rng.normal(0, 0.3, (nq, 3))
        qp[b, :nq] = p[np.argsort(p[:, 0], kind="stable")]
    q, ref = torch.tensor(qp, device=cuda), torch.tensor(refp, device=cuda)
    n_q, n_ref = _i32([n for n, _ in live], cuda), _i32([n for _, n in live],
                                                        cuda)
    windows = [KN.tile_windows(q[b, :, 0], n_q[b], ref[b, :, 0],
                               torch.arange(M, device=cuda) < n_ref[b], tq, tm,
                               margin + 1e-3) for b in range(B)]
    t_lo = torch.stack([w[0] for w in windows]).contiguous()
    t_hi = torch.stack([w[1] for w in windows]).contiguous()
    idx, d2 = KN.knn_topk_dyn(q, ref, n_q, n_ref, k, t_lo, t_hi, tq=tq, tm=tm)
    idx_p, d2_p = KN.knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                                    tq=tq, tm=tm)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    assert (d2[0, :6000, k - 1] < margin).sum() > 3000
    assert (d2[1, 1536:] == 1e30).all()


@pytest.mark.parametrize("surf,truncate", [(False, True), (True, True),
                                           (True, False)])
def test_odom_corr_kernel_matches_plain(cuda, surf, truncate):
    rng = np.random.default_rng(7)
    B, Q, M = 2, 256, 2048
    rings = np.sort(rng.integers(0, 16, (B, M)), axis=1)
    ref = torch.tensor(rng.uniform(-10, 10, (B, M, 3)), dtype=torch.float32,
                       device=cuda)
    j1 = _i32(rng.integers(-1, 1500, (B, Q)), cuda)
    q = (torch.gather(ref, 1, j1.clamp(min=0).long()[..., None].expand(
        B, Q, 3)) + torch.tensor(rng.normal(0, 0.3, (B, Q, 3)),
                                 device=cuda)).float().contiguous()
    args = (q, ref, _i32(rings, cuda), j1, _i32([200, Q], cuda),
            _i32([1500, 1800], cuda))
    kw = dict(surf=surf, window=LoamConfig().ring_window, truncate=truncate)
    before = OC.odom_corr.launches
    out = OC.odom_corr(*args, **kw)
    assert OC.odom_corr.launches == before + 1
    plain = OC.odom_corr_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert (out[0] >= 0).sum() > Q


def _lattice(rng, shape, half=2):
    """Coordinates on a 0.25 m lattice: many exactly equal distances."""
    return (rng.integers(-half, half + 1, size=shape) * 0.25).astype(
        np.float32)


# name -> (Q, M, live sizes of the two problems, lattice coordinates)
NEAREST_CASES = {
    "ties_ragged": (300, 640, (500, 333), True),
    "empty_and_tiny": (70, 256, (0, 3), True),
    "one_slice_ragged": (33, 100, (100, 1), False),
    "corner": (256, 2048, (1365, 2048), False),
    "surf": (512, 16384, (10922, 16384), False),
    "surf_ties": (512, 16384, (10922, 129), True),
}


@pytest.mark.parametrize("case", list(NEAREST_CASES))
def test_knn_nearest_kernel_matches_plain(cuda, case):
    """The k=1 kernel (reference slices merged by an atomic minimum on a
    (distance, index) key) equals the plain version bit for bit: exact
    ties, empty and one-point references, query counts that leave the
    last block ragged, and the replay's corner and surf shapes."""
    Q, M, live, lattice = NEAREST_CASES[case]
    rng = np.random.default_rng(Q + M)
    if lattice:
        ref_np, q_np = _lattice(rng, (2, M, 3)), _lattice(rng, (2, Q, 3))
    else:
        ref_np = rng.uniform(-30, 30, (2, M, 3)).astype(np.float32)
        q_np = (ref_np[:, rng.integers(0, min(live) or 1, Q)]
                + rng.normal(0, 0.2, (2, Q, 3))).astype(np.float32)
    q, ref = torch.tensor(q_np, device=cuda), torch.tensor(ref_np, device=cuda)
    n_ref = _i32(live, cuda)
    before = KN.knn_topk.launches
    idx, d2 = KN.knn_topk(q, ref, n_ref, 1, tq=Q, tm=M)
    assert KN.knn_topk.launches == before + 1
    assert idx.shape == d2.shape == (2, Q, 1)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    lo, hi = KN.full_windows(2, Q, M, Q, M, cuda)
    idx_p, d2_p = KN.knn_topk_plain(q, ref, _i32([Q, Q], cuda), n_ref, 1,
                                    lo, hi, tq=Q, tm=M)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    for b, n in enumerate(live):
        if n == 0:
            assert (idx[b] == 0).all() and (d2[b] == 1e30).all()
        else:
            assert (d2[b] < 1e29).all() and int(idx[b].max()) < n


# name -> (Q, M, live sizes, feature counts, ring order, lattice)
CORR_CASES = {
    "ties_sorted": (70, 640, (500, 333), (40, 70), "sorted", True),
    "ties_jittered": (70, 640, (500, 333), (40, 70), "jittered", True),
    "ties_shuffled": (131, 640, (640, 200), (131, 5), "shuffled", True),
    "empty_reference": (64, 256, (0, 0), (64, 64), "sorted", True),
    "corner": (256, 2048, (1365, 2048), (200, 256), "sorted", False),
    "surf": (512, 16384, (10922, 16384), (384, 512), "sorted", False),
    "surf_ties": (512, 16384, (10922, 7000), (384, 512), "jittered", True),
}


@pytest.mark.parametrize("surf,truncate", [(False, True), (True, True),
                                           (True, False)])
@pytest.mark.parametrize("case", list(CORR_CASES))
def test_odom_corr_kernel_ties_and_ring_orders(cuda, case, surf, truncate):
    """The warp-a-query walk equals the plain version bit for bit on
    exact ties within and across the two sides, on ring ids that are
    sorted, locally out of order and fully shuffled, on rows without a
    1-NN (and one problem with none at all), on empty references, with a
    ragged last block, and at the replay's shapes."""
    Q, M, live, n_q, order, lattice = CORR_CASES[case]
    rng = np.random.default_rng(Q + M + len(case))
    rings = np.sort(rng.integers(0, 16, (2, M)), axis=1)
    if order == "jittered":
        rings = np.clip(rings + rng.integers(-2, 3, (2, M)), 0, 15)
    elif order == "shuffled":
        rings = rng.permuted(rings, axis=1)
    # -1 or a live index: all -1 where the reference is empty
    j1_np = np.stack([rng.integers(0, max(n, 1), Q) for n in live])
    j1_np = np.minimum(j1_np, np.array(live)[:, None] - 1)
    j1_np[:, ::5] = -1
    j1_np[1, :] = -1 if case == "ties_sorted" else j1_np[1]
    if lattice:
        ref_np, q_np = _lattice(rng, (2, M, 3)), _lattice(rng, (2, Q, 3))
    else:
        ref_np = rng.uniform(-30, 30, (2, M, 3)).astype(np.float32)
        q_np = (np.take_along_axis(ref_np, np.maximum(j1_np, 0)[..., None], 1)
                + rng.normal(0, 0.3, (2, Q, 3))).astype(np.float32)
    args = (torch.tensor(q_np, device=cuda), torch.tensor(ref_np, device=cuda),
            _i32(rings, cuda), _i32(j1_np, cuda), _i32(n_q, cuda),
            _i32(live, cuda))
    kw = dict(surf=surf, window=LoamConfig().ring_window, truncate=truncate)
    before = OC.odom_corr.launches
    out = OC.odom_corr(*args, **kw)
    assert OC.odom_corr.launches == before + 1
    plain = OC.odom_corr_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (out[0][:, ::5] == -1).all() and (out[2][:, ::5] == 1e30).all()
    if case == "empty_reference":
        assert (out[0] == -1).all() and (out[1] == -1).all()
    elif order != "shuffled":     # a shuffled walk breaks after a step or two
        assert (out[0][0] >= 0).sum() > Q // 4


@pytest.mark.parametrize("corner_k,flat_k",
                         [(0, 0), (7, 7), (33, 33), (3, 0), (0, 7)])
@pytest.mark.parametrize("W", [512, 1024, 2048])
@pytest.mark.parametrize("B,R", [(1, 1), (1, 16), (1, 208), (8, 34)])
def test_select_walk_kernel_matches_plain(cuda, B, R, W, corner_k, flat_k):
    """The warp-a-ring walk equals the plain version on every output, on
    the constructed meta of torch_parity.walk_meta_case (quota overflow,
    picked runs past the two staged chunks, stop candidates first, rings
    under 12 points, reaches across words and subregions, index W-1, bit
    31), the corner and flat walks cut at corner_k and flat_k candidates
    (0: the whole subregion)."""
    cm, fm, p0, _ = walk_meta_case(B, R, W, seed=R + W + corner_k + flat_k)
    kw = walk_kwargs(LoamConfig(), W, corner_k, flat_k)
    cm, fm = (torch.tensor(a, device=cuda) for a in (cm, fm))
    p0 = SW.pack_bits(torch.tensor(p0, device=cuda))
    before = SW.select_walk.launches
    out = SW.select_walk(cm, fm, p0, **kw)
    assert SW.select_walk.launches == before + 1
    plain = SW.select_walk_plain(cm, fm, p0, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(out[0].count_nonzero()) > 0 and int(out[2].count_nonzero()) > 0


@pytest.mark.parametrize("Q,C,k,frac", [(300, 864, 24, 0.6), (1000, 24, 5, 0.7),
                                        (1000, 8, 5, 0.5), (37, 130, 3, 0.1),
                                        (5, 1024, 32, 0.9)])
def test_kselect_kernel_matches_plain(cuda, Q, C, k, frac):
    """Coordinates and squared distances equal to the plain version, with
    duplicated candidates, exact ties (a coarse lattice), rows with fewer
    than k valid candidates and rows with none."""
    rng = np.random.default_rng(C + k)
    half = rng.integers(-3, 4, size=(Q, C // 2, 3)).astype(np.float32) * 0.25
    cand = np.concatenate([half, half], 1)
    valid = rng.uniform(size=(Q, C)) < frac
    valid[::5, k - 1:] = False
    valid[::11] = False
    q = rng.integers(-2, 3, size=(Q, 3)).astype(np.float32) * 0.25
    cand, valid, q = (torch.tensor(a, device=cuda) for a in (cand, valid, q))
    before = KS.knn_select.launches
    pts, d2 = KS.knn_select(cand, valid, q, k)
    assert KS.knn_select.launches == before + 1
    pts_p, d2_p = KS.knn_select_plain(cand, valid, q, k)
    torch.cuda.synchronize()
    assert torch.equal(d2, d2_p) and torch.equal(pts, pts_p)
    assert (d2[::11] == 1e30).all() and (d2 < 1e29).any()


# C, k, Q: the re-rank shapes (eight lanes a query), their edges (C = 1,
# 30, 32), the warp kernel with and without 16-byte aligned rows (33, 866),
# its limits, Q that leaves the last group or block ragged, and Q large
# enough that a warp walks several queries
KSELECT_LATTICE = [(8, 5, 37), (24, 5, 37), (24, 24, 1001), (1, 1, 9),
                   (30, 7, 37), (32, 32, 131), (33, 5, 37), (36, 32, 6000),
                   (864, 24, 37), (866, 24, 150), (1024, 32, 3000),
                   (864, 1, 2048)]


@pytest.mark.parametrize("C,k,Q", KSELECT_LATTICE)
def test_kselect_kernel_lattice_matches_plain(cuda, C, k, Q):
    """Lattice candidates (exact ties in every row), rows of fewer than k
    and of no valid candidates: coordinates and distances equal the plain
    version's and a stable argsort's, bit for bit."""
    case = kselect_lattice_case(Q, C, k)
    cand, valid, q = (torch.tensor(a, device=cuda) for a in case)
    before = KS.knn_select.launches
    pts, d2 = KS.knn_select(cand, valid, q, k)
    assert KS.knn_select.launches == before + 1
    pts_p, d2_p = KS.knn_select_plain(cand, valid, q, k)
    torch.cuda.synchronize()
    assert torch.equal(d2, d2_p) and torch.equal(pts, pts_p)
    want_pts, want_d2 = kselect_argsort(*case, k)
    np.testing.assert_array_equal(d2.cpu().numpy(), want_d2)
    np.testing.assert_array_equal(pts.cpu().numpy(), want_pts)


@pytest.mark.parametrize("Q,C,k", [(2048, 864, 24), (8192, 24, 5),
                                   (8192, 8, 5)])
def test_kselect_kernel_replay_shapes(cuda, Q, C, k):
    """The gather chunk and the two re-rank shapes of the cached mapping
    modes on continuous clouds, and the gather chunk once more from a
    base pointer that is not 16-byte aligned (plain loads in place of
    asynchronous copies)."""
    rng = np.random.default_rng(C)
    q_np = rng.uniform(-30, 30, (Q, 3)).astype(np.float32)
    cand_np = (q_np[:, None] + rng.normal(0, 0.8, (Q, C, 3))).astype(
        np.float32)
    valid_np = rng.uniform(size=(Q, C)) < 0.6
    valid_np[::7, max(k - 4, 0):] = False
    cand, valid, q = (torch.tensor(a, device=cuda)
                      for a in (cand_np, valid_np, q_np))
    want = KS.knn_select_plain(cand, valid, q, k)
    got = KS.knn_select(cand, valid, q, k)
    shifted = torch.empty(cand.numel() + 1, device=cuda)[1:].view_as(cand)
    shifted.copy_(cand)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    got_shifted = KS.knn_select(shifted, valid, q, k)
    torch.cuda.synchronize()
    for out in (got, got_shifted):
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    assert (want[1][:, 0] < 1e29).sum() > Q // 2


def test_replay_modes_agree_with_cpu(cuda):
    """Two frames of each mapping mode on the card (kernels) against the
    same replay on the CPU (plain versions): same cadence, poses within
    1e-3 m / 1e-4 rad (the card takes the normal-equation sums in
    another order and the map's index_add atomically; one mapping solve
    moves by ~2e-4 m, and the recurrence carries it on)."""
    from loam_tpu_torch import pipeline
    from loam_tpu_torch.io import synth

    world = synth.make_world(seed=3)
    poses = synth.straight_trajectory(4, speed=0.9, yaw_rate=0.12)
    poses = np.vstack([poses[:1], poses])[:5]
    sweeps = [synth.simulate_sweep(world, poses[i], poses[i + 1],
                                   n_azimuth=480, seed=3 + i)
              for i in range(4)]
    raw = np.stack([s[0] for s in sweeps]).astype(np.float32)
    msk = np.stack([s[1] for s in sweeps])
    base = dataclasses.replace(
        LoamConfig(), ring_width=512, max_less_flat=2048,
        less_flat_ring_cap=256, corner_table_size=1 << 12,
        surf_table_size=1 << 13, search_buckets=1 << 10,
        max_corner_from_map=1024, max_surf_from_map=2048,
        max_corner_stack=512, max_surf_stack=1024, odom_max_iters=5)
    for mode in (dict(map_exact_regather_every=5), dict(map_exact_knn=False)):
        cfg = dataclasses.replace(base, **mode)
        before = KS.knn_select.launches
        gpu = pipeline.replay_sweeps(raw, msk, cfg)      # the default device
        assert gpu.pose_integrated.device.type == "cuda"
        assert KS.knn_select.launches > before
        cpu = pipeline.replay_sweeps(raw, msk, cfg, device="cpu")
        assert torch.equal(gpu.mapped.cpu(), cpu.mapped)
        diff = (gpu.pose_integrated.cpu() - cpu.pose_integrated).abs()
        assert diff[:, :3].max() < 1e-4 and diff[:, 3:].max() < 1e-3, diff


@pytest.mark.parametrize("mode", [{}, dict(map_exact_regather_every=5),
                                  dict(map_exact_knn=False)])
def test_batched_replay_equals_single_replays_on_card(cuda, mode):
    """Three scenarios of five frames in one batched_replay on the card
    equal three single replays on the card bit for bit, in each mapping
    mode: every product and sum whose cuBLAS or reduction algorithm the
    batch's shape would choose runs one scenario at a time
    (types.per_scenario), and every kernel launch serves each scenario
    of its grid alike."""
    from loam_tpu_torch import pipeline
    from loam_tpu_torch.io import synth
    from loam_tpu_torch.parallel import replay

    raws, msks = [], []
    for seed, speed, yaw_rate in ((3, 0.9, 0.12), (5, 1.5, 0.35),
                                  (9, 0.6, -0.2)):
        world = synth.make_world(seed=seed)
        poses = synth.straight_trajectory(5, speed=speed, yaw_rate=yaw_rate)
        poses = np.vstack([poses[:1], poses])[:6]
        sweeps = [synth.simulate_sweep(world, poses[i], poses[i + 1],
                                       n_azimuth=480, seed=seed + i)
                  for i in range(5)]
        raws.append(np.stack([s[0] for s in sweeps]).astype(np.float32))
        msks.append(np.stack([s[1] for s in sweeps]))
    raw, msk = np.stack(raws), np.stack(msks)
    cfg = dataclasses.replace(
        LoamConfig(), ring_width=512, max_less_flat=2048,
        less_flat_ring_cap=256, corner_table_size=1 << 12,
        surf_table_size=1 << 13, search_buckets=1 << 10,
        max_corner_from_map=1024, max_surf_from_map=2048,
        max_corner_stack=512, max_surf_stack=1024, **mode)
    batched = replay.batched_replay(raw, msk, cfg)
    assert batched.pose_integrated.device.type == "cuda"
    for b in range(3):
        single = pipeline.replay_sweeps(raw[b], msk[b], cfg)
        for name in ("pose_odom", "pose_aft", "pose_integrated", "mapped"):
            assert torch.equal(getattr(batched, name)[b],
                               getattr(single, name)), (b, name)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor goes to the kernel or raises; nothing falls back."""
    q = torch.zeros(1, 256, 3, dtype=torch.float64, device=cuda)
    ref = torch.zeros(1, 512, 3, device=cuda)
    with pytest.raises(ValueError, match="float"):
        KN.knn_topk(q, ref, _i32([10], cuda), 1, tq=256, tm=512)
    with pytest.raises(ValueError, match="unsupported k"):
        KN.knn_topk(q.float(), ref, _i32([10], cuda), 3, tq=256, tm=512)
    with pytest.raises(ValueError, match="expected torch.bool"):
        KS.knn_select(torch.zeros(4, 8, 3, device=cuda),
                      torch.ones(4, 8, dtype=torch.uint8, device=cuda),
                      torch.zeros(4, 3, device=cuda), 5)
    with pytest.raises(ValueError, match="k=9"):
        KS.knn_select(torch.zeros(4, 8, 3, device=cuda),
                      torch.ones(4, 8, dtype=torch.bool, device=cuda),
                      torch.zeros(4, 3, device=cuda), 9)


def test_cli_runs_on_card(cuda, tmp_path):
    """The command line without --device runs on the card: four synthetic
    sweeps with the cloud streams launch the kernels, and its
    trajectories are those of a replay of the same sweeps on the card."""
    from loam_tpu_torch import cli, pipeline
    from loam_tpu_torch.io import export

    argv = ["--synthetic", "4", "--ring-width", "512"]
    before = SW.select_walk.launches, KN.knn_topk.launches
    assert cli.main(argv + ["--out-dir", str(tmp_path), "--stream-clouds",
                            "--report-timing"]) == 0
    assert SW.select_walk.launches > before[0]
    assert KN.knn_topk.launches > before[1]
    assert sorted(p.name for p in (tmp_path / "clouds").iterdir()) == [
        "registered_0001.ply", "registered_0003.ply", "surround_0003.ply"]
    args = cli.build_parser().parse_args(argv)
    cfg = dataclasses.replace(cli._config(args), emit_registered=True)
    raw, msk, stamps, _ = cli._load_data(args, cfg)
    outs = pipeline.replay_sweeps(raw, msk, cfg)
    export.save_trajectory_tum(str(tmp_path / "ref.tum"), stamps,
                               outs.pose_integrated.cpu().numpy())
    assert (tmp_path / "integrated.tum").read_bytes() == \
        (tmp_path / "ref.tum").read_bytes()
