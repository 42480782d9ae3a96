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

from torch_parity import (REFUSED, REFUSED_IDS, WIDE_K, kselect_argsort,
                          kselect_lattice_case, make_sweeps, small_config,
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


# the queue sizes' edges: k = 2^n and 2^n + 1 from 32 to the limit
QUEUE_EDGES = [(k, 8, 128) for k in (33, 64, 65, 128, 129, 256, 257, 512,
                                     513)] + [(1024, 8, 256)]


def knn_instance(k):
    """The instance knn_topk_launch reports for k: k itself for the
    per-lane lists (k <= 8), else W of the warp queue, the smallest power
    of two >= k from 32."""
    return k if k <= 8 else max(32, 1 << (k - 1).bit_length())


@pytest.mark.parametrize("k,tq,tm", [(k, 40, 10) for k in range(1, 33)]
                         + [(40, 40, 10), (100, 8, 128), (812, 8, 128)]
                         + QUEUE_EDGES)
def test_knn_kernel_any_k_matches_plain(cuda, k, tq, tm):
    """Every k the exact paths may ask for: the per-lane register lists
    at k = 1-8 and, past 8, the warp queue of W = 32 to 1024 pairs (k
    launched at the smallest W >= k, its first k pairs stored; each
    size's edges), on the lattice problems of windowed_knn_case (blocks
    with fewer than k visible references among them), bit-equal to the
    plain version and the row-at-a-time reference."""
    case = windowed_knn_case(tq, tm, seed=k)
    q, ref, n_q, n_ref, t_lo, t_hi = (torch.tensor(a, device=cuda)
                                      for a in case)
    before = dict(KN.knn_topk_dyn.by_k)
    idx, d2 = KN.knn_topk_dyn(q, ref, n_q, n_ref, k, t_lo, t_hi, tq=tq, tm=tm)
    K = knn_instance(k)
    assert KN.knn_topk_dyn.by_k[K] == before.get(K, 0) + 1
    assert idx.shape == d2.shape == (3, q.shape[1], k)
    idx_p, d2_p = KN.knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                                    tq=tq, tm=tm)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    want_idx, want_d2 = windowed_knn_scalar(*case, k, tq, tm)
    np.testing.assert_array_equal(idx.cpu().numpy(), want_idx)
    np.testing.assert_array_equal(d2.cpu().numpy(), want_d2)


@pytest.mark.parametrize("k", [16, 40])
def test_knn_warp_queue_sorted_slabs(cuda, k):
    """The warp queue on the mapping k-NN's data (chip_smoke.sorted_cloud:
    slabs of references sorted on x, queries around them, 2 m tile
    windows), two scenarios in one launch, bit-equal to the plain version
    and the row-at-a-time reference."""
    import chip_smoke

    rng = np.random.default_rng(k)
    B, Q, M, n_q, n_ref, tq, tm = 2, 2048, 16384, 1500, 12000, 256, 512
    q, ref, t_lo, t_hi = chip_smoke.sorted_cloud(rng, cuda, B, Q, M, n_q,
                                                 n_ref, 2.0, tq, tm)
    nq_t, nr_t = _i32([n_q] * B, cuda), _i32([n_ref] * B, cuda)
    before = dict(KN.knn_topk_dyn.by_k)
    idx, d2 = KN.knn_topk_dyn(q, ref, nq_t, nr_t, k, t_lo, t_hi, tq=tq,
                              tm=tm)
    K = knn_instance(k)
    assert KN.knn_topk_dyn.by_k[K] == before.get(K, 0) + 1
    idx_p, d2_p = KN.knn_topk_plain(q, ref, nq_t, nr_t, k, t_lo, t_hi,
                                    tq=tq, tm=tm)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    case = [t.cpu().numpy() for t in (q, ref, nq_t, nr_t, t_lo, t_hi)]
    want_idx, want_d2 = windowed_knn_scalar(*case, k, tq, tm)
    np.testing.assert_array_equal(idx.cpu().numpy(), want_idx)
    np.testing.assert_array_equal(d2.cpu().numpy(), want_d2)
    assert (d2[:, :n_q] < 1e29).all()      # every live row finds k


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


WIDE_WALKS = [(B, R, W, depth, depth) for W in (1800, 3600, 7200, 8192)
              for B, R in ((1, 16), (1, 208)) for depth in (0, 33)]


@pytest.mark.parametrize("B,R,W,corner_k,flat_k", [
    (B, R, W, c, f) for c, f in ((0, 0), (7, 7), (33, 33), (3, 0), (0, 7))
    for W in (512, 1024, 2048) for B, R in ((1, 1), (1, 16), (1, 208),
                                            (8, 34))] + WIDE_WALKS)
def test_select_walk_kernel_matches_plain(cuda, B, R, W, corner_k, flat_k):
    """The warp-a-ring walk equals the plain version on every output, on
    the constructed meta of torch_parity.walk_meta_case (quota overflow,
    picked runs past the two staged chunks, stop candidates first, rings
    under 12 points, reaches across words and subregions, index W-1, bit
    31), the corner and flat walks cut at corner_k and flat_k candidates
    (0: the whole subregion); rings wider than 2048 (13-bit indices, 4 and
    8 bit-field words a lane) and not a multiple of 32 (1800, 3600, 7200:
    a VLP-16 at 300 RPM in dual-return mode)."""
    cm, fm, p0, _ = walk_meta_case(B, R, W, seed=R + W + corner_k + flat_k)
    kw = walk_kwargs(LoamConfig(), W, corner_k, flat_k)
    cm, fm = (torch.tensor(a, device=cuda) for a in (cm, fm))
    p0 = SW.pack_bits(torch.tensor(p0, device=cuda))
    before = SW.select_walk.launches
    nw = 2 if W <= 2048 else 4 if W <= 4096 else 8   # the C entry's choice
    words = SW.select_walk.by_words.get(nw, 0)
    out = SW.select_walk(cm, fm, p0, **kw)
    assert SW.select_walk.launches == before + 1
    assert SW.select_walk.by_words[nw] == words + 1
    plain = SW.select_walk_plain(cm, fm, p0, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(out[0].count_nonzero()) > 0 and int(out[2].count_nonzero()) > 0


@pytest.mark.parametrize("W,depth", [(W, d) for W in (512, 2048, 3600, 7200,
                                                    8192) for d in (0, 10)])
def test_select_walk_kernel_matches_plain_at_the_largest_reach(cuda, W, depth):
    """Reaches up to select_walk.MAX_REACH (suppress_neighbors 16): a
    pick's span of 33 bits across two words of the picked bit-field, on
    the constructed meta of torch_parity.walk_meta_case, at the 2, 4 and
    8 words a lane, the whole subregion and a depth of 10."""
    B, R = 1, 208
    cm, fm, p0, _ = walk_meta_case(B, R, W, seed=W + depth,
                                   reach=SW.MAX_REACH)
    kw = walk_kwargs(LoamConfig(), W, depth, depth)
    cm, fm = (torch.tensor(a, device=cuda) for a in (cm, fm))
    p0 = SW.pack_bits(torch.tensor(p0, device=cuda))
    out = SW.select_walk(cm, fm, p0, **kw)
    plain = SW.select_walk_plain(cm, fm, p0, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(out[0].count_nonzero()) > 0 and int(out[2].count_nonzero()) > 0


@pytest.mark.parametrize("reach", [8, 16])
def test_select_rings_on_card_equals_cpu_at_reach(cuda, reach):
    """Feature labels of a sweep at suppress_neighbors 8 and 16: the walk
    kernel on the card gives the CPU's labels bit for bit."""
    from loam_tpu_torch import frontend
    from loam_tpu_torch.ops import features as FT

    raw, msk, _ = make_sweeps(1)
    cfg = dataclasses.replace(small_config(), suppress_neighbors=reach)
    labels = []
    for dev in ("cpu", cuda):
        sweep = frontend.ingest_sweep(torch.tensor(raw[0], device=dev),
                                      torch.tensor(msk[0], device=dev), cfg)
        W = cfg.ring_width
        curv, gap, pre, counts = FT.selection_inputs(sweep, cfg)
        before = SW.select_walk.launches
        lab, _ = FT.select_rings(curv.reshape(-1, W), gap.reshape(-1, W),
                                 pre.reshape(-1, W), counts.reshape(-1), cfg)
        assert SW.select_walk.launches == before + (dev != "cpu")
        labels.append(lab.cpu())
    assert torch.equal(labels[0], labels[1])
    assert int((labels[0] == 2).sum()) > 0


@pytest.mark.parametrize("Q,C,k,frac", [(300, 864, 24, 0.6), (1000, 24, 5, 0.7),
                                        (1000, 8, 5, 0.5), (37, 130, 3, 0.1),
                                        (5, 1024, 32, 0.9),
                                        (300, 1296, 40, 0.6),
                                        (300, 2160, 64, 0.6),
                                        (1000, 32, 5, 0.6), (1000, 33, 5, 0.6),
                                        (1000, 64, 5, 0.6), (1000, 65, 5, 0.6),
                                        (300, 1296, 64, 0.6),
                                        (300, 1296, 65, 0.6)])
def test_kselect_kernel_matches_plain(cuda, Q, C, k, frac):
    """Coordinates and squared distances equal to the plain version, with
    duplicated candidates, exact ties (a coarse lattice), rows with fewer
    than k valid candidates and rows with none."""
    rng = np.random.default_rng(C + k)
    half = rng.integers(-3, 4, size=(Q, (C + 1) // 2, 3)).astype(
        np.float32) * 0.25
    cand = np.concatenate([half, half], 1)[:, :C]
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


# C, k, Q: the re-rank shapes (a group of eight lanes a query), their
# edges (C = 1, 30, 32), the group's rows of five to eight candidates a
# lane (33, 40, 64, and k = C there), the warp kernel past 64 (65; two
# keys a lane up to k = 48, eight past it: k = 1, 48, 49, 64, 65 and C
# at C = 1296, several rounds at k = C), rows with and without 16-byte
# alignment (866, 1298), the limit (C = 17880, three warps a block), Q
# that leaves the last group or block ragged, and Q large enough that a
# warp walks several queries
KSELECT_LATTICE = [(8, 5, 37), (24, 5, 37), (24, 24, 1001), (1, 1, 9),
                   (30, 7, 37), (32, 32, 131), (33, 5, 37), (36, 32, 6000),
                   (40, 5, 1001), (48, 48, 37), (49, 5, 37), (64, 5, 37),
                   (64, 64, 131), (65, 5, 37), (65, 65, 37),
                   (864, 24, 37), (866, 24, 150), (1024, 32, 3000),
                   (864, 1, 2048), (1296, 40, 300), (1298, 40, 300),
                   (1296, 1, 300), (1296, 48, 300), (1296, 49, 300),
                   (1296, 64, 300), (1296, 65, 300), (1296, 1296, 20),
                   (2160, 64, 200), (17880, 40, 20), (17880, 100, 20)]


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
                                   (8192, 8, 5), (2048, 1296, 40),
                                   (8192, 40, 5), (8192, 64, 5),
                                   (2048, 1296, 100)])
def test_kselect_kernel_replay_shapes(cuda, Q, C, k):
    """The gather chunk and the two re-rank shapes of the cached mapping
    modes and of the dense cell on continuous clouds, and each once more
    from a base pointer that is not 16-byte aligned (the warp kernel's
    scalar loads in place of 16-byte ones)."""
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


@pytest.mark.parametrize("C,k", [(40, 40), (40, 39), (1296, 1296),
                                 (1296, 1295), (1296, 40)])
def test_kselect_kernel_overflowed_distance(cuda, C, k):
    """Valid candidates at 1e20 (a squared distance that overflows to
    +inf), one a row, every valid one in some rows and every candidate
    in others: once only +inf
    distances are left, every pick is candidate 0 at +inf, as in the
    plain version, on the group kernel and on the warp kernel."""
    Q = 64
    rng = np.random.default_rng(C + k)
    q_np = rng.uniform(-30, 30, (Q, 3)).astype(np.float32)
    cand_np = (q_np[:, None] + rng.normal(0, 0.8, (Q, C, 3))).astype(
        np.float32)
    valid_np = rng.uniform(size=(Q, C)) < 0.6
    valid_np[:, C // 3] = True
    cand_np[:, C // 3] = 1e20
    cand_np[::4][valid_np[::4]] = 1e20
    valid_np[2::16] = True     # every candidate valid and overflowed
    cand_np[2::16] = 1e20
    cand, valid, q = (torch.tensor(a, device=cuda)
                      for a in (cand_np, valid_np, q_np))
    want = KS.knn_select_plain(cand, valid, q, k)
    got = KS.knn_select(cand, valid, q, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isinf(want[1][2::16]).all()
    if k == C:
        assert torch.isinf(want[1][:, -1]).all()


def test_replay_modes_agree_with_cpu(cuda):
    """Two frames of each mapping mode on the card (kernels) against the
    same replay on the CPU (plain versions): same cadence, poses within
    1e-3 m / 1e-4 rad (the card takes the normal-equation sums in
    another order and the map's index_add atomically; one mapping solve
    moves by ~2e-4 m, and the recurrence carries it on)."""
    from loam_tpu_torch import pipeline

    raw, msk, _ = make_sweeps(4)
    base = small_config()
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


@pytest.mark.parametrize("T", [0.05, 0.1, 0.2])
def test_sweep_time_on_card_equals_cpu(cuda, T):
    """A point's sweep fraction decoded by scan_period T: on the card bit
    for bit what the CPU gives for the same encoded times (1 / T taken
    in double, one float32 multiply on either device); at 0.1 s also the
    fixed decode 10 * frac of the C++ and loam_tpu."""
    from loam_tpu_torch import frontend
    from loam_tpu_torch.types import PointCloud

    raw, msk, _ = make_sweeps(1, scan_period=T)
    cfg = dataclasses.replace(small_config(), scan_period=T)
    cpu = frontend.ingest_sweep(torch.tensor(raw[0]), torch.tensor(msk[0]),
                                cfg).flatten()
    card = PointCloud(xyz=cpu.xyz.to(cuda), rel=cpu.rel.to(cuda),
                      mask=cpu.mask.to(cuda))
    got = card.sweep_time(T)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), cpu.sweep_time(T))
    if T == 0.1:
        assert torch.equal(got, 10.0 * (card.rel - torch.trunc(card.rel)))
    assert float(got[card.mask].max()) > 0.99


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


def test_kernel_limits_are_the_wrappers(cuda):
    """The limits the configuration check holds without the libraries
    (MAX_K, MAX_C, MAX_W) are those the libraries report."""
    from loam_tpu_torch.ops.cuda import _build

    assert _build.entry("knn_topk", (), "max_k")() == KN.MAX_K == 1024
    assert _build.entry("kselect", (), "max_c")() == KS.MAX_C == 17880
    assert _build.entry("select_walk", (), "max_w")() == SW.MAX_W == 8192


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor goes to the kernel or raises; nothing falls back."""
    q = torch.zeros(1, 256, 3, dtype=torch.float64, device=cuda)
    ref = torch.zeros(1, 512, 3, device=cuda)
    with pytest.raises(ValueError, match="float"):
        KN.knn_topk(q, ref, _i32([10], cuda), 1, tq=256, tm=512)
    with pytest.raises(ValueError, match="unsupported k=1025"):
        KN.knn_topk(q.float(), ref, _i32([10], cuda), 1025, tq=256, tm=512)
    with pytest.raises(ValueError, match="expected torch.bool"):
        KS.knn_select(torch.zeros(4, 8, 3, device=cuda),
                      torch.ones(4, 8, dtype=torch.uint8, device=cuda),
                      torch.zeros(4, 3, device=cuda), 5)
    with pytest.raises(ValueError, match="k=9"):
        KS.knn_select(torch.zeros(4, 8, 3, device=cuda),
                      torch.ones(4, 8, dtype=torch.bool, device=cuda),
                      torch.zeros(4, 3, device=cuda), 9)
    with pytest.raises(ValueError, match="C=17881"):
        KS.knn_select(torch.zeros(1, 17881, 3, device=cuda),
                      torch.ones(1, 17881, dtype=torch.bool, device=cuda),
                      torch.zeros(1, 3, device=cuda), 5)
    meta = torch.zeros(1, 1, 6 * (8224 // 6 + 8), dtype=torch.int32,
                       device=cuda)
    with pytest.raises(ValueError, match="W=8224"):
        SW.select_walk(meta, meta, torch.zeros(1, 1, 257, dtype=torch.int64,
                                               device=cuda),
                       **walk_kwargs(LoamConfig(), 8224))


# the kernel instance each former refusal must launch: (wrapper, its
# tally, key)
WIDE_K_LAUNCHES = {
    "strict": (KN.knn_topk_dyn, "by_k", 3),
    "hybrid": (KN.knn_topk_dyn, "by_k", 32),
    "cells_k": (KS.knn_select, "by_shape", (864, 40)),
    "cells_C": (KS.knn_select, "by_shape", (1080, 24)),
}


def _teacher_forced_mapping(raw, msk, cfg, devices):
    """The mapping step of the last sweep from one state on each device:
    the first F - 1 sweeps replayed on the CPU, the last sweep's odometry
    on the CPU, then mapping.mapping_step on each device from copies of
    that state.  Returns each device's pose_aft on the CPU."""
    from loam_tpu_torch import frontend, mapping, odometry, pipeline
    from loam_tpu_torch.ops.features import extract_features
    from loam_tpu_torch.state import pipeline_state_from_numpy

    from torch_parity import tree_to_numpy

    _, st = pipeline.replay_sweeps(raw[:-1], msk[:-1], cfg, device="cpu",
                                   return_state=True)
    feats = extract_features(frontend.ingest_sweep(
        torch.tensor(raw[-1]), torch.tensor(msk[-1]), cfg), cfg)
    _, odom = odometry.odometry_step(st.odom, feats, cfg)
    assert bool(odom.publish_to_mapping)
    poses = []
    for dev in devices:
        state = pipeline_state_from_numpy(tree_to_numpy(st), device=dev)
        _, out = mapping.mapping_step(
            state.map, odom.pose.to(dev),
            odom.corner_last.map(lambda t: t.to(dev)),
            odom.surf_last.map(lambda t: t.to(dev)), cfg)
        assert bool(out.solved)
        poses.append(out.pose_aft.cpu())
    return poses


@pytest.mark.parametrize(
    "over,match", [(over, None) for _, over in WIDE_K]
    + [case[1:] for case in REFUSED],
    ids=[name for name, _ in WIDE_K] + REFUSED_IDS)
def test_config_refusals_match_the_cpu(cuda, over, match):
    """The configurations the port once refused (torch_parity.WIDE_K)
    replay on the card through the new kernel instances, on the CPU's
    cadence, their first two frames within the batch's 1e-4 rad / 1e-3 m
    of the CPU's; and the last sweep's mapping step, from one state on
    both devices, lands within the CPU mapping tests' 1e-6 rad / 1e-5 m
    of the CPU's.  (The later frames of a whole replay of these four
    sweeps are no test of a bound: one ulp of the input moves the
    frame-3 solve by up to 1.5e-4 rad or 1.35e-3 m on either device,
    profile_torch_conditioning.py.)  What is still refused (k > C on the
    cell path, the kernels' limits) is refused on the card with the
    CPU's ValueError, before any kernel launches."""
    from loam_tpu_torch import pipeline

    wrappers = (KN.knn_topk, KN.knn_topk_dyn, OC.odom_corr, SW.select_walk,
                KS.knn_select)
    if match is None:
        raw, msk, _ = make_sweeps(4)
        cfg = dataclasses.replace(small_config(), **over)
        name = next(n for n, o in WIDE_K if o == over)
        fn, tally, key = WIDE_K_LAUNCHES[name]
        before = getattr(fn, tally).get(key, 0)
        gpu = pipeline.replay_sweeps(raw, msk, cfg)
        assert getattr(fn, tally)[key] > before
        assert torch.isfinite(gpu.pose_integrated).all()
        cpu = pipeline.replay_sweeps(raw, msk, cfg, device="cpu")
        assert torch.equal(gpu.mapped.cpu(), cpu.mapped)
        for field in ("pose_odom", "pose_aft", "pose_integrated"):
            diff = (getattr(gpu, field)[:2].cpu()
                    - getattr(cpu, field)[:2]).abs()
            print(f"{name}: {field} frames 0-1, card - CPU "
                  f"{diff[:, :3].max():.3g} rad, {diff[:, 3:].max():.3g} m")
            assert diff[:, :3].max() < 1e-4 and diff[:, 3:].max() < 1e-3, \
                (field, diff)
        step_cpu, step_gpu = _teacher_forced_mapping(raw, msk, cfg,
                                                     ("cpu", cuda))
        diff = (step_gpu - step_cpu).abs()
        print(f"{name}: teacher-forced mapping step, card - CPU "
              f"{diff[:3].max():.3g} rad, {diff[3:].max():.3g} m")
        assert diff[:3].max() < 1e-6 and diff[3:].max() < 1e-5, diff
        return
    cfg = dataclasses.replace(LoamConfig(), **over)
    raw = np.zeros((1, cfg.max_points, 3), np.float32)
    msk = np.ones(raw.shape[:2], bool)
    before = [fn.launches for fn in wrappers]
    errors = []
    for device in ("cpu", cuda):
        with pytest.raises(ValueError, match=match) as err:
            pipeline.replay_sweeps(raw, msk, cfg, device=device)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert [fn.launches for fn in wrappers] == before


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


def _engine_case(imu: bool):
    """Six sweeps of 480 azimuths (straight, or along the oscillating
    trajectory with its raw 200 Hz IMU) and the configuration of the
    replay tests above."""
    from torch_parity import imu_samples, raw_imu
    from loam_tpu_torch.io import synth

    cfg = dataclasses.replace(
        LoamConfig(), ring_width=512, max_less_flat=2048,
        less_flat_ring_cap=256, corner_table_size=1 << 12,
        surf_table_size=1 << 13, search_buckets=1 << 10,
        max_corner_from_map=1024, max_surf_from_map=2048,
        max_corner_stack=512, max_surf_stack=1024)
    world = synth.make_world(seed=11)
    t_scans = 0.06 + 0.1 * np.arange(6)
    if imu:
        pose_fn = synth.oscillating_trajectory()
        sweeps = [synth.simulate_sweep_traj(world, pose_fn, t0=float(t),
                                            n_azimuth=480, seed=11 + k)
                  for k, t in enumerate(t_scans)]
        imu_t, pyr, acc = imu_samples(pose_fn, float(t_scans[-1]) + 0.25)
        samples = (imu_t,) + raw_imu(pyr, acc)
    else:
        poses = synth.straight_trajectory(6, speed=0.9, yaw_rate=0.12)
        poses = np.vstack([poses[:1], poses])[:7]
        sweeps = [synth.simulate_sweep(world, poses[i], poses[i + 1],
                                       n_azimuth=480, seed=11 + i)
                  for i in range(6)]
        samples = None
    raw = np.stack([s[0] for s in sweeps]).astype(np.float32)
    msk = np.stack([s[1] for s in sweeps])
    return cfg, raw, msk, t_scans, samples


@pytest.mark.parametrize("imu", [False, True])
def test_streaming_engine_equals_replay_on_card(cuda, imu):
    """A paced engine run on the card (its stages launch the kernels
    from three threads) equals the card's replay of the same sweeps and
    IMU windows bit for bit, by the engine's integration rule: the
    frontend of one sweep rounds as the replay's frame batch does."""
    from loam_tpu_torch import imu as imu_mod
    from loam_tpu_torch.runtime.streaming import StreamingEngine
    from torch_parity import (masked_imu_windows, online_rule_replay,
                              paced_engine_run)

    cfg, raw, msk, t_scans, samples = _engine_case(imu)
    wrappers = (KN.knn_topk, KN.knn_topk_dyn, OC.odom_corr, SW.select_walk)
    before = [fn.launches for fn in wrappers]
    eng = StreamingEngine(cfg)                  # the default device
    assert eng.device.type == "cuda"
    eng.start()
    try:
        odom, aft, integrated = paced_engine_run(eng, raw, msk, t_scans,
                                                 samples)
        windows = [eng._imu_window(float(t)) for t in t_scans]
    finally:
        eng.stop()
    assert all(fn.launches > b for fn, b in zip(wrappers, before))
    if imu:
        streams = imu_mod.imu_from_raw(*(
            torch.tensor(np.stack([w[i] for w in windows]), device=cuda)
            for i in range(4)))
    else:
        streams = masked_imu_windows(len(t_scans), device=cuda)
    t_t = torch.tensor(t_scans.astype(np.float32), device=cuda)
    ref, online = online_rule_replay(raw, msk, cfg, cuda, streams, t_t)
    np.testing.assert_array_equal(odom, ref.pose_odom.cpu().numpy())
    np.testing.assert_array_equal(aft, ref.pose_aft.cpu().numpy())
    np.testing.assert_array_equal(integrated, online.cpu().numpy())


def test_streaming_engine_sheds_load_on_card(cuda):
    """Thirty sweeps with no pacing: the oldest are dropped and every
    sweep is accounted for."""
    from loam_tpu_torch.runtime.streaming import StreamingEngine

    cfg, raw, msk, _, _ = _engine_case(False)
    eng = StreamingEngine(cfg)
    eng.start()
    try:
        eng.push_sweep(raw[0], msk[0])
        assert eng.drain(timeout_s=120)
        for k in range(30):
            eng.push_sweep(raw[k % 6], msk[k % 6])
        assert eng.drain(timeout_s=300)
        st = eng.stats()
    finally:
        eng.stop()
    q = st.queue_stats
    assert st.frames_in == 31 and q["raw"]["dropped"] > 0
    assert st.odom_frames + q["raw"]["dropped"] + q["feats"]["dropped"] == 31


def test_two_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """Two ranks on the one card over gloo (tests/torch_dcn_worker.py) at
    the tiny configuration with rings of 512: the dp=2 replay of four
    scenarios gathers the same poses on both ranks, bit-equal to one
    process's batched replay on the card; the tp=2 replay (rows split
    over the ranks) is bit-equal across the ranks and within 5e-4 of the
    unsplit replay; the tp=2 dry run is finite."""
    from loam_tpu_torch.parallel import replay
    from torch_dcn_worker import POSES, run_ranks, worker_cfg
    from torch_parity import make_sweeps

    scen = [make_sweeps(5, seed=s, speed=v, yaw_rate=w)
            for s, v, w in ((3, 0.9, 0.12), (2, 0.9, 0.12),
                            (6, 0.8, -0.12), (9, 0.6, 0.2))]
    raw = np.stack([s[0] for s in scen])
    msk = np.stack([s[1] for s in scen])
    (r0, r1), _ = run_ranks(str(tmp_path), dict(raw=raw, msk=msk), "replay",
                            device="cuda", timeout=300)
    ref = replay.batched_replay(raw, msk, worker_cfg())
    for n in POSES:
        want = getattr(ref, n).cpu().numpy()
        np.testing.assert_array_equal(r0[f"dp_{n}"], r1[f"dp_{n}"])
        np.testing.assert_array_equal(r0[f"dp_{n}"], want)
        np.testing.assert_array_equal(r0[f"tp_{n}"], r1[f"tp_{n}"])
        np.testing.assert_allclose(r0[f"tp_{n}"], want[:2], rtol=0,
                                   atol=5e-4)
    assert int(r0["dp_path_calls"]) == 0 and int(r0["tp_all_reduce"]) > 0
    assert r0["dp_rate"] == r1["dp_rate"] > 0
    assert np.isfinite(r0["dry_pose"]).all()
