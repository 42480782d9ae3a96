"""The port's kernel contracts, held against the JAX package.

On the CPU every kernel wrapper of loam_tpu_torch runs its plain torch
version; here those run on seeded NumPy inputs against the Pallas
kernels in interpret mode and the jnp references, as
tests/test_pallas_odom_corr.py, tests/test_knn_prune.py and
tests/test_select_walk.py hold the Pallas kernels themselves.  Indices
and labels must be identical on non-degenerate clouds (no two candidate
distances within the Pallas keys' ~2^-15 mantissa truncation).
The CUDA kernels themselves are held against these plain versions on
the card by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu.config import LoamConfig
from loam_tpu.odometry import _corner_correspondences, _surf_correspondences
from loam_tpu.ops import features as JFT
from loam_tpu.ops.pallas import knn_topk as JKN
from loam_tpu.ops.pallas.odom_corr import odom_correspondences as j_corr
from loam_tpu.types import PointCloud as JCloud

from loam_tpu_torch.ops import features as TFT
from loam_tpu_torch.ops.cuda import knn_topk as TKN
from loam_tpu_torch.ops.cuda import odom_corr as TOC
from loam_tpu_torch.ops.cuda import select_walk as TSW

from torch_parity import (WALK_KINDS, serial_walk, to_port_cfg,
                          walk_kwargs, walk_meta_case, windowed_knn_case,
                          windowed_knn_scalar)

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_knn_topk_plain_matches_pallas_and_reference():
    """k=1 and k=5 over a partly masked reference: the exact plain
    version picks the same neighbours, in the same order, as the Pallas
    kernel (interpret) and knn_topk_reference."""
    rng = np.random.default_rng(1)
    Q, M, n_ref = 64, 256, 200
    ref = rng.uniform(-5.0, 5.0, size=(M, 3)).astype(np.float32)
    ref[n_ref:] = 0.0
    ref_mask = np.arange(M) < n_ref
    q = rng.uniform(-5.0, 5.0, size=(Q, 3)).astype(np.float32)
    for k in (1, 5):
        idx_p, _ = JKN.knn_topk(jnp.asarray(q), None, jnp.asarray(ref),
                                jnp.asarray(ref_mask), k, tq=Q, tm=M,
                                interpret=True)
        idx_r, _ = JKN.knn_topk_reference(jnp.asarray(q), None,
                                          jnp.asarray(ref),
                                          jnp.asarray(ref_mask), k)
        idx_t, d2_t = TKN.knn_topk(_t(q)[None], _t(ref)[None],
                                   torch.tensor([n_ref], dtype=torch.int32),
                                   k, tq=64, tm=128)
        np.testing.assert_array_equal(idx_t[0].numpy(), np.asarray(idx_p))
        np.testing.assert_array_equal(idx_t[0].numpy(), np.asarray(idx_r))
        # exact distances: the plain version reports (q - r)^2 itself
        p = ref[idx_t[0].numpy()]
        np.testing.assert_array_equal(
            d2_t[0].numpy(), ((q[:, None, :] - p) ** 2).sum(-1))


def _sorted_case(rng, n_ref, n_q, M, Q, axis):
    """A reference 16 m long on `axis` and 2 m across (dense enough that
    most queries have 5 neighbours within the 1 m gate), sorted on it."""
    half = np.where(np.arange(3) == axis, 8.0, 1.0)
    ref = rng.uniform(-half, half, (n_ref, 3)).astype(np.float32)
    ref = ref[np.argsort(ref[:, axis], kind="stable")]
    refp = np.zeros((M, 3), np.float32)
    refp[:n_ref] = ref
    q = ref[rng.integers(0, n_ref, n_q)] + rng.normal(0, 0.3, (n_q, 3))
    q = q[np.argsort(q[:, axis], kind="stable")].astype(np.float32)
    qp = np.zeros((Q, 3), np.float32)
    qp[:n_q] = q
    return qp, refp, np.arange(M) < n_ref


@pytest.mark.parametrize("axis,K,M,n_ref", [
    pytest.param(0, 5, 1024, 700, id="0"),
    pytest.param(1, 5, 1024, 750, id="1"),
    pytest.param(2, 5, 1024, 800, id="2"),
    # the warp queue's k (a denser reference, so that k neighbours fill
    # the gate for most queries)
    pytest.param(0, 16, 1024, 1000, id="0-k16"),
    pytest.param(0, 40, 2048, 2000, id="0-k40")])
def test_knn_topk_dyn_plain_matches_pallas_windows(axis, K, M, n_ref):
    """The windowed mapping k-NN: same windows (tile_windows of both
    packages agree), same live blocks, identical k-NN for every query
    whose k neighbours lie inside the 1 m gate, and both reject the
    others."""
    rng = np.random.default_rng(2 + axis)
    Q, tq, tm, gate = 512, 128, 128, 1.0
    n_q = 300 + 40 * axis
    qp, refp, rmask = _sorted_case(rng, n_ref, n_q, M, Q, axis)
    jt_lo, jt_hi = JKN.tile_windows(jnp.asarray(qp[:, axis]), n_q,
                                    jnp.asarray(refp[:, axis]),
                                    jnp.asarray(rmask), tq, tm, gate + 1e-3)
    t_lo, t_hi = TKN.tile_windows(_t(qp[:, axis]), torch.tensor(n_q),
                                  _t(refp[:, axis]), _t(rmask), tq, tm,
                                  gate + 1e-3)
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(jt_lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(jt_hi))

    idx_j, d2_j = JKN.knn_topk_dyn(
        jnp.asarray(qp), jnp.asarray(refp), jnp.asarray(rmask), n_q, n_ref,
        K, tq=tq, tm=tm, interpret=True, t_lo=jt_lo, t_hi=jt_hi)
    idx_t, d2_t = TKN.knn_topk_dyn(
        _t(qp)[None], _t(refp)[None], torch.tensor([n_q], dtype=torch.int32),
        torch.tensor([n_ref], dtype=torch.int32), K, t_lo[None], t_hi[None],
        tq=tq, tm=tm)
    # dead query blocks keep the empty fill
    blk_end = -(-n_q // tq) * tq
    assert (d2_t[0, blk_end:].numpy() > 1e28).all()
    idx_j, d2_j = np.asarray(idx_j)[:n_q], np.asarray(d2_j)[:n_q]
    idx_t, d2_t = idx_t[0, :n_q].numpy(), d2_t[0, :n_q].numpy()
    gated = d2_t[:, K - 1] < gate
    assert gated.sum() > n_q // 2
    # the plain version reports exact (q - r)^2; the Pallas kernel's
    # |q|^2 - 2 q.r + |r|^2 cancels ~eps * |q|^2 ~ 1e-5 at 8 m from
    # the origin, plus its ~2^-15 key truncation: its distances are good
    # to atol.  Among 16 or 40 neighbours some rows hold two whose exact
    # distances differ by less than that, an order the reference cannot
    # decide; past k = 8 the indices are compared on the other rows
    atol = 2e-4
    decided = gated
    if K > 8:
        _, d2_next = TKN.knn_topk_dyn(
            _t(qp)[None], _t(refp)[None],
            torch.tensor([n_q], dtype=torch.int32),
            torch.tensor([n_ref], dtype=torch.int32), K + 1, t_lo[None],
            t_hi[None], tq=tq, tm=tm)
        gaps = np.diff(d2_next[0, :n_q].numpy(), axis=1).min(1)
        decided = gated & (gaps > atol)
        assert decided.sum() > n_q // 2
    np.testing.assert_array_equal(idx_t[decided], idx_j[decided])
    p = refp[idx_t]
    np.testing.assert_array_equal(
        d2_t[gated], ((qp[:n_q, None, :] - p) ** 2).sum(-1)[gated])
    np.testing.assert_allclose(d2_t[gated], d2_j[gated], atol=atol)
    assert (d2_j[~gated, K - 1] >= gate * 0.99).all()


def _ring_cloud(rng, m, n_valid, spread=8.0):
    rings = np.sort(rng.integers(0, 16, size=n_valid))
    xyz = rng.uniform(-spread, spread, size=(m, 3)).astype(np.float32)
    xyz[n_valid:] = 0.0
    rel = np.zeros(m, np.float32)
    rel[:n_valid] = rings + 0.1 * rng.uniform(0.0, 0.9, size=n_valid)
    return xyz, rel, np.arange(m) < n_valid


@pytest.mark.parametrize("surf", [False, True])
def test_odom_corr_plain_matches_pallas_and_jnp_walks(surf):
    """2nd/3rd correspondence points through the port's plain walk equal
    the jnp walks and the Pallas kernel (interpret) on a non-degenerate
    ring-sorted cloud, with masked queries and upward truncation."""
    cfg = LoamConfig()
    rng = np.random.default_rng(0)
    Q, M, NV = 64, 256, 230
    xyz, rel, mask = _ring_cloud(rng, M, NV)
    proj = (xyz[rng.integers(0, NV, Q)]
            + rng.normal(0.0, 0.05, (Q, 3))).astype(np.float32)
    q_mask = np.arange(Q) < Q - 4
    n_q = Q - 4
    last = JCloud(jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask))
    args = (cfg.odom_nn_gate_sq, cfg.ring_window,
            cfg.emulate_upward_scan_truncation)
    walks = _surf_correspondences if surf else _corner_correspondences
    ref_out = walks(jnp.asarray(proj), jnp.asarray(q_mask), last,
                    jnp.int32(n_q), cfg)
    pallas_out = j_corr(jnp.asarray(proj), jnp.asarray(q_mask), last.xyz,
                        last.mask, last.ring(), jnp.int32(n_q), *args,
                        surf=surf, interpret=True)
    port_out = TOC.odom_correspondences(
        _t(proj), _t(q_mask), _t(xyz), _t(mask),
        torch.trunc(_t(rel)).to(torch.int32), torch.tensor(n_q), *args,
        surf=surf)
    assert len(port_out) == len(ref_out) == len(pallas_out)
    for p, r, k in zip(port_out, ref_out, pallas_out):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        np.testing.assert_array_equal(p.numpy(), np.asarray(k))
    assert (port_out[1].numpy() >= 0).sum() > Q // 2


def test_odom_corr_plain_empty_and_padding():
    """j1 with an immediate upward ring break and no downward side, and
    an all-padding reference: every 2nd/3rd point is -1."""
    cfg = LoamConfig()
    M = 128
    xyz = np.zeros((M, 3), np.float32)
    rel = np.zeros(M, np.float32)
    xyz[0] = (0.2, 0.0, 0.0)
    rel[0] = 0.05
    xyz[1:] = np.linspace(1.0, 2.0, M - 1)[:, None] * np.array([0, 1.0, 0])
    rel[1:] = 10.0
    proj = torch.tensor([[0.1, 0.0, 0.0]] * 8)
    ring = torch.trunc(_t(rel)).to(torch.int32)
    args = (cfg.odom_nn_gate_sq, cfg.ring_window, True)
    for surf in (False, True):
        out = TOC.odom_correspondences(
            proj, torch.ones(8, dtype=torch.bool), _t(xyz),
            torch.ones(M, dtype=torch.bool), ring, torch.tensor(8), *args,
            surf=surf)
        assert (out[0].numpy() == 0).all()
        for j in out[1:]:
            assert (j.numpy() == -1).all()
        out = TOC.odom_correspondences(
            torch.zeros(8, 3), torch.ones(8, dtype=torch.bool),
            torch.zeros(M, 3), torch.zeros(M, dtype=torch.bool),
            torch.zeros(M, dtype=torch.int32), torch.tensor(8), *args,
            surf=surf)
        for j in out:
            assert (j.numpy() == -1).all()


def _ring_case(R, W, seed):
    """Random curvature/gap rings (tests/test_select_walk.py:_ring_case)."""
    rng = np.random.default_rng(seed)
    curv = rng.exponential(0.03, size=(R, W)).astype(np.float32)
    spikes = rng.uniform(size=(R, W)) < 0.08
    curv = np.where(spikes, rng.exponential(1.5, size=(R, W)), curv)
    gap = rng.exponential(0.01, size=(R, W)).astype(np.float32)
    big = rng.uniform(size=(R, W)) < 0.04
    gap = np.where(big, rng.uniform(0.1, 2.0, size=(R, W)), gap)
    pre = rng.uniform(size=(R, W)) < 0.05
    n = rng.integers(int(W * 0.5), W, size=(R,)).astype(np.int32)
    n[0], n[1] = 5, 13
    return (curv.astype(np.float32), gap.astype(np.float32), pre, n)


@pytest.mark.parametrize("W,seed", [(512, 3), (256, 11)])
def test_select_walk_plain_matches_pallas_and_select_ring(W, seed):
    """Labels and final picked masks of the plain walk equal the Pallas
    walk (interpret) and the JAX default select_ring, bit for bit."""
    cfg = dataclasses.replace(LoamConfig(), ring_width=W)
    curv, gap, pre, n = _ring_case(8, W, seed)
    lab_t, pick_t = TFT.select_rings(_t(curv), _t(gap), _t(pre), _t(n),
                                     to_port_cfg(cfg))
    lab_k, pick_k = JFT.select_rings_walk(
        jnp.asarray(curv), jnp.asarray(gap), jnp.asarray(pre),
        jnp.asarray(n), cfg, interpret=True)
    lab_x, pick_x = jax.vmap(
        lambda c, g, p, nn: JFT.select_ring(jnp.zeros((W, 3)), c, g, p, nn,
                                            cfg)
    )(jnp.asarray(curv), jnp.asarray(gap), jnp.asarray(pre), jnp.asarray(n))
    for ref_lab, ref_pick in ((lab_k, pick_k), (lab_x, pick_x)):
        np.testing.assert_array_equal(lab_t.numpy(), np.asarray(ref_lab))
        np.testing.assert_array_equal(pick_t.numpy(), np.asarray(ref_pick))
    assert (lab_t.numpy() == 2).sum() > 0 and (lab_t.numpy() == -1).sum() > 0


@pytest.mark.parametrize("W,seed", [(600, 5), (2400, 7)])
def test_select_rings_wide_and_ragged_match_select_ring(W, seed):
    """Rings wider than 2048 (13-bit indices, more bit-field words) and
    not a multiple of 32 (a ragged last word): labels and picked masks of
    the port's walk equal the JAX default select_ring bit for bit."""
    cfg = dataclasses.replace(LoamConfig(), ring_width=W)
    curv, gap, pre, n = _ring_case(8, W, seed)
    n[2] = W                                    # a full ring: index W-1
    lab_t, pick_t = TFT.select_rings(_t(curv), _t(gap), _t(pre), _t(n),
                                     to_port_cfg(cfg))
    lab_x, pick_x = jax.vmap(
        lambda c, g, p, nn: JFT.select_ring(jnp.zeros((W, 3)), c, g, p, nn,
                                            cfg)
    )(jnp.asarray(curv), jnp.asarray(gap), jnp.asarray(pre), jnp.asarray(n))
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_x))
    np.testing.assert_array_equal(pick_t.numpy(), np.asarray(pick_x))
    assert (lab_t.numpy() == 2).sum() > 0 and (lab_t.numpy() == -1).sum() > 0
    assert pick_t.shape == (8, W)


@pytest.mark.parametrize("corner_k,flat_k", [(3, 3), (40, 40), (3, 40),
                                              (40, 0)])
def test_select_rings_scan_depth_matches_select_ring(corner_k, flat_k):
    """corner_scan_k / flat_scan_k cut the port's walk where they cut the
    JAX default select_ring: labels and picked masks bit for bit."""
    W = 512
    cfg = dataclasses.replace(LoamConfig(), ring_width=W,
                              corner_scan_k=corner_k, flat_scan_k=flat_k)
    curv, gap, pre, n = _ring_case(8, W, 5)
    lab_t, pick_t = TFT.select_rings(_t(curv), _t(gap), _t(pre), _t(n),
                                     to_port_cfg(cfg))
    lab_x, pick_x = jax.vmap(
        lambda c, g, p, nn: JFT.select_ring(jnp.zeros((W, 3)), c, g, p, nn,
                                            cfg)
    )(jnp.asarray(curv), jnp.asarray(gap), jnp.asarray(pre), jnp.asarray(n))
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_x))
    np.testing.assert_array_equal(pick_t.numpy(), np.asarray(pick_x))
    full, _ = TFT.select_rings(_t(curv), _t(gap), _t(pre), _t(n),
                               to_port_cfg(dataclasses.replace(
                                   cfg, corner_scan_k=0, flat_scan_k=0)))
    if 3 in (corner_k, flat_k):      # a depth of 3 cuts walks here
        assert (lab_t.numpy() != full.numpy()).any()


@pytest.mark.parametrize("ties", [False, True])
def test_select_argmax_labels_match_select_rings_argmax(ties):
    """select_argmax=True runs the walk: its labels and picked masks equal
    the JAX package's fixed-trip-count select_rings_argmax, on random
    rings and on curvature quantised into exact ties around the
    threshold (tests/test_select_argmax.py's cases)."""
    W = 256 if ties else 512
    cfg = dataclasses.replace(LoamConfig(), ring_width=W, select_argmax=True)
    curv, gap, pre, n = _ring_case(8, W, 17)
    if ties:
        rng = np.random.default_rng(23)
        curv = (rng.integers(0, 6, size=curv.shape) * 0.06).astype(
            np.float32)
        n = np.full_like(n, W)
    lab_t, pick_t = TFT.select_rings(_t(curv), _t(gap), _t(pre), _t(n),
                                     to_port_cfg(cfg))
    lab_a, pick_a = jax.jit(
        lambda c, g, p, nn: JFT.select_rings_argmax(c, g, p, nn, cfg)
    )(jnp.asarray(curv), jnp.asarray(gap), jnp.asarray(pre), jnp.asarray(n))
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_a))
    np.testing.assert_array_equal(pick_t.numpy(), np.asarray(pick_a))
    assert (lab_t.numpy() == 2).sum() > 0 and (lab_t.numpy() == -1).sum() > 0


@pytest.mark.parametrize("W", [512, 2048, 600, 3600])
@pytest.mark.parametrize("depth", [1, 7, 32, 33, 0])
def test_select_walk_plain_matches_serial_walk(W, depth):
    """The plain walk equals a one-candidate-at-a-time NumPy walk on
    constructed meta (torch_parity.walk_meta_case): quota overflow in
    every subregion, long picked runs, stop candidates first, rings under
    12 points, reaches across words and subregions, index W-1, bit 31;
    at depths 1, 7, 32, 33 and the whole subregion; at widths that are
    not a multiple of 32 (600, 3600: the last word's tail stays 0) and
    past 2048 (3600: 13-bit ring indices)."""
    B, R = 2, 6
    cm, fm, p0, kinds = walk_meta_case(B, R, W, seed=W + depth)
    kw = walk_kwargs(to_port_cfg(LoamConfig()), W, depth, depth)
    got = TSW.select_walk_plain(_t(cm), _t(fm), TSW.pack_bits(_t(p0)), **kw)
    want, counts = serial_walk(cm.reshape(B * R, -1), fm.reshape(B * R, -1),
                               p0.reshape(B * R, W), **kw)
    for g, w in zip(got, want):
        assert g.shape == (B, R, -(-W // 32))
        np.testing.assert_array_equal(
            TSW.unpack_bits(g, W).numpy().reshape(B * R, W), w)
        if W % 32:                   # a ragged last word: its tail is 0
            assert int((g[..., -1] >> (W % 32)).max()) == 0
    kind = np.array(WALK_KINDS)[kinds.reshape(-1)]
    n_walks = 2 * kw["n_sub"]
    # a short ring and stop-first walks end at their first candidates
    assert (counts["walked"][kind == "short_ring"] == n_walks).all()
    assert (counts["walked"][kind == "stop_first"]
            == min(depth or 2, 2) * kw["n_sub"] + kw["n_sub"]).all()
    if depth == 0:
        # every subregion: 20 corners labelled (the 21st overflows), 4 flats
        assert (counts["picks"][kind == "overflow"] == kw["n_sub"] * 24).all()
        # picked runs walk past the two chunks the kernel stages
        assert (counts["walked"][kind == "picked_runs"] > n_walks * 64).all()
    assert want[0][kind == "edges"][:, W - 1].all()   # index W-1, bit 31


@pytest.mark.parametrize("corner_k,flat_k", [(3, 0), (0, 7), (40, 2)])
def test_select_walk_plain_split_depths_match_serial_walk(corner_k, flat_k):
    """Each walk keeps its own depth: the plain walk equals the NumPy walk
    when the corner and flat depths differ."""
    B, R, W = 2, 6, 512
    cm, fm, p0, _ = walk_meta_case(B, R, W, seed=corner_k + 10 * flat_k)
    kw = walk_kwargs(to_port_cfg(LoamConfig()), W, corner_k, flat_k)
    got = TSW.select_walk_plain(_t(cm), _t(fm), TSW.pack_bits(_t(p0)), **kw)
    want, _ = serial_walk(cm.reshape(B * R, -1), fm.reshape(B * R, -1),
                          p0.reshape(B * R, W), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            TSW.unpack_bits(g, W).numpy().reshape(B * R, W), w)
    assert want[2].any()


@pytest.mark.parametrize("W", [128, 600])
def test_walk_bits_roundtrip(W):
    """Bit-fields pack into ceil(W/32) uint32 words, the tail of a ragged
    last word zero, and unpack to the same W bits."""
    rng = np.random.default_rng(1)
    m = torch.tensor(rng.uniform(size=(3, W)) < 0.3)
    words = TSW.pack_bits(m)
    assert words.shape == (3, -(-W // 32))
    assert int(words.max()) < 2 ** 32
    assert int(words[:, -1].max()) < 2 ** (W - 32 * (-(-W // 32) - 1))
    assert torch.equal(TSW.unpack_bits(words, W), m)


# ---- exact ties: the (distance, index) rule of odom_corr and knn_topk

def _lattice(rng, shape, half=2):
    """Coordinates on a 0.25 m lattice: many exactly equal distances."""
    return (rng.integers(-half, half + 1, size=shape) * 0.25).astype(
        np.float32)


def _sq_np(q, r):
    """round(round(dx^2 + dy^2) + dz^2) in float32, like the kernels."""
    d = (q - r).astype(np.float32)
    return np.float32(np.float32(d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])


def _serial_walks(q, ref, ring, j1, n_q, n_ref, surf, window, truncate):
    """The reference's two loops a query, one point at a time: upward
    keeps the first best (<), downward the last best (<=), and the
    downward side wins a tie at the merge.  Returns (j2, j3, d2, d3) and
    the number of queries whose two sides tied exactly."""
    Q, M = q.shape[0], ref.shape[0]
    big = np.float32(1e30)
    out_j = np.full((2, Q), -1, np.int32)
    out_d = np.full((2, Q), big, np.float32)
    cross_ties = 0
    nr = min(int(n_ref), M)
    for i in range(Q):
        j = int(j1[i])
        up = [[big, -1], [big, -1]]
        dn = [[big, -1], [big, -1]]
        if 0 <= j < nr:
            cr = np.float32(ring[j])
            up_end = min(nr, int(n_q)) if truncate else nr
            for c in range(j + 1, up_end):
                r = np.float32(ring[c])
                if r > cr + np.float32(window):
                    break
                el = ((r <= cr) if surf else (r > cr), surf and r > cr)
                d = _sq_np(q[i], ref[c])
                for s in range(2):
                    if el[s] and d < up[s][0]:
                        up[s] = [d, c]
            for c in range(j - 1, -1, -1):
                r = np.float32(ring[c])
                if r < cr - np.float32(window):
                    break
                el = ((r >= cr) if surf else (r < cr), surf and r < cr)
                d = _sq_np(q[i], ref[c])
                for s in range(2):
                    if el[s] and d <= dn[s][0]:
                        dn[s] = [d, c]
        for s in range(2):
            u, d_ = up[s], dn[s]
            cross_ties += u[1] >= 0 and d_[1] >= 0 and u[0] == d_[0]
            best = d_ if d_[1] >= 0 and (u[1] < 0 or d_[0] <= u[0]) else u
            out_d[s, i], out_j[s, i] = best
    return out_j[0], out_j[1], out_d[0], out_d[1], cross_ties


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("truncate", [True, False])
@pytest.mark.parametrize("surf", [False, True])
def test_odom_corr_plain_ties_match_serial_walks(surf, truncate, shuffled):
    """On lattice clouds, where equal distances occur within a side and
    across the two sides, the plain version picks what the serial walks
    pick: the minimum of (distance, index).  Ring ids sorted or not,
    rows without a 1-NN, and a batch entry with an empty reference."""
    rng = np.random.default_rng(5 + 2 * surf + truncate)
    B, Q, M = 2, 96, 256
    n_ref, n_q = np.array([220, 0], np.int32), np.array([150, 40], np.int32)
    ref = _lattice(rng, (B, M, 3))
    q = _lattice(rng, (B, Q, 3))
    ring = np.sort(rng.integers(0, 16, size=(B, M)), axis=1)
    if shuffled:    # out of order: breaks come early, at either kind of edge
        ring = np.clip(ring + rng.integers(-2, 3, size=(B, M)), 0, 15)
    ring = ring.astype(np.int32)
    j1 = rng.integers(0, 220, size=(B, Q)).astype(np.int32)
    j1[:, ::6] = -1
    kw = dict(surf=surf, window=LoamConfig().ring_window, truncate=truncate)
    out = TOC.odom_corr(_t(q), _t(ref), _t(ring), _t(j1), _t(n_q),
                        _t(n_ref), **kw)
    ties = 0
    for b in range(B):
        *want, cross = _serial_walks(q[b], ref[b], ring[b], j1[b], n_q[b],
                                     n_ref[b], **kw)
        ties += cross
        for got, w in zip(out, want):
            np.testing.assert_array_equal(got[b].numpy(), w)
    assert ties > 0                              # the merge rule was used
    assert (out[0][0].numpy() >= 0).sum() > Q // 2
    assert (out[0][1].numpy() == -1).all()       # the empty reference
    assert (out[0][0].numpy()[::6] == -1).all()  # rows without a 1-NN
    if surf:
        assert (out[1][0].numpy() >= 0).sum() > Q // 4
    else:
        assert (out[1].numpy() == -1).all() and (out[3].numpy() > 1e29).all()


@pytest.mark.parametrize("n_live", [0, 1, 150])
def test_odom_correspondences_hands_the_walk_a_live_nearest(monkeypatch,
                                                            n_live):
    """The walk's contract takes j1 = -1 or a live index below n_ref (the
    kernel and the plain version differ beyond it): the caller's gates
    keep to that with a full, a one-point and an empty reference, also
    for masked queries and queries beyond the 25 m^2 gate."""
    cfg = LoamConfig()
    rng = np.random.default_rng(n_live)
    Q, M = 48, 256
    xyz, rel, _ = _ring_cloud(rng, M, M)
    mask = np.arange(M) < n_live
    proj = (xyz[rng.integers(0, M, Q)]
            + rng.normal(0.0, 0.05, (Q, 3))).astype(np.float32)
    proj[::7] += 50.0                            # beyond the gate
    seen = []
    walk = TOC.odom_corr

    def spy(q, ref, ring, j1, n_q, n_ref, **kw):
        seen.append((j1.clone(), n_ref.clone()))
        return walk(q, ref, ring, j1, n_q, n_ref, **kw)

    monkeypatch.setattr(TOC, "odom_corr", spy)
    out = TOC.odom_correspondences(
        _t(proj), _t(np.arange(Q) < Q - 4), _t(xyz), _t(mask),
        torch.trunc(_t(rel)).to(torch.int32), torch.tensor(Q - 4),
        cfg.odom_nn_gate_sq, cfg.ring_window, True, surf=True)
    (j1, n_ref), = seen
    assert int(n_ref) == n_live
    assert ((j1 == -1) | ((j1 >= 0) & (j1 < n_ref[:, None]))).all()
    assert (j1[0, ::7] == -1).all() and (j1[0, Q - 4:] == -1).all()
    assert torch.equal(out[0], j1[0].long())
    if n_live > 1:
        assert (j1 >= 0).sum() > Q // 2


@pytest.mark.parametrize("Q,M,n_ref,tq,tm", [(64, 256, 200, 64, 128),
                                             (96, 128, 128, 32, 128),
                                             (40, 128, 1, 40, 128),
                                             (64, 256, 0, 16, 64)])
def test_knn_topk_plain_nearest_ties_match_argmin(Q, M, n_ref, tq, tm):
    """k=1 on lattice clouds against argmin over float32 distances taken
    in the kernels' order: ties go to the smaller index, an empty
    reference reads (0, 1e30)."""
    rng = np.random.default_rng(Q + n_ref)
    ref = _lattice(rng, (M, 3))
    q = _lattice(rng, (Q, 3))
    idx, d2 = TKN.knn_topk(_t(q)[None], _t(ref)[None],
                           torch.tensor([n_ref], dtype=torch.int32), 1,
                           tq=tq, tm=tm)
    assert idx.shape == d2.shape == (1, Q, 1)
    if n_ref == 0:
        assert (idx.numpy() == 0).all()
        assert (d2.numpy() == np.float32(1e30)).all()
        return
    dist = np.array([[_sq_np(q[i], ref[j]) for j in range(n_ref)]
                     for i in range(Q)], np.float32)
    want = dist.argmin(1)
    np.testing.assert_array_equal(idx[0, :, 0].numpy(), want)
    np.testing.assert_array_equal(d2[0, :, 0].numpy(),
                                  dist[np.arange(Q), want])
    if n_ref > 1:       # ties did occur, and the first index took them
        assert ((dist == dist.min(1, keepdims=True)).sum(1) > 1).sum() > Q // 4


@pytest.mark.parametrize("k", [5, 8, 12, 16, 40])
def test_knn_topk_plain_windows_ties_match_scalar(k):
    """The windowed k-NN on lattice clouds against the K smallest
    (distance, index) pairs of the visible references taken one row at a
    time: rows past n_q in a live block are searched, a block with fewer
    than K visible references and one with an empty window pad with
    (0, 1e30), dead blocks and a problem without references are all
    fill."""
    tq, tm = 8, 16
    q, ref, n_q, n_ref, t_lo, t_hi = windowed_knn_case(tq, tm, seed=k)
    idx, d2 = TKN.knn_topk_dyn(*(_t(a) for a in (q, ref, n_q, n_ref)), k,
                               _t(t_lo), _t(t_hi), tq=tq, tm=tm)
    want_idx, want_d2 = windowed_knn_scalar(q, ref, n_q, n_ref, t_lo, t_hi,
                                            k, tq, tm)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(d2.numpy(), want_d2)
    d2 = d2.numpy()
    found = d2 < 1e29
    assert found[0, int(n_q[0]):5 * tq].all()      # rows past n_q, live block
    assert (found[0, tq:2 * tq].sum(1) == 3).all()  # fewer than K visible
    assert not found[0, 2 * tq:3 * tq].any()        # empty window
    assert not found[0, 5 * tq:].any()              # dead blocks
    assert not found[1].any()                       # n_ref = 0
    assert found[2, :tq].all() and not found[2, tq:].any()
    # ties did decide: equal distances next to each other, indices rising
    same = found[0, :, 1:] & (d2[0, :, 1:] == d2[0, :, :-1])
    assert same.sum() > tq
    assert (np.diff(idx.numpy()[0], axis=1)[same] > 0).all()
