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


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_knn_topk_dyn_plain_matches_pallas_windows(axis):
    """The windowed mapping k-NN: same windows (tile_windows of both
    packages agree), same live blocks, identical 5-NN for every query
    inside the 1 m gate, and both reject the others."""
    rng = np.random.default_rng(2 + axis)
    Q, M, tq, tm, K, gate = 512, 1024, 128, 128, 5, 1.0
    n_ref, n_q = 700 + 50 * axis, 300 + 40 * axis
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
    np.testing.assert_array_equal(idx_t[gated], idx_j[gated])
    # the plain version reports exact (q - r)^2; the Pallas kernel's
    # |q|^2 - 2 q.r + |r|^2 cancels ~eps * |q|^2 ~ 1e-5 at 8 m from
    # the origin, plus its ~2^-15 key truncation
    p = refp[idx_t]
    np.testing.assert_array_equal(
        d2_t[gated], ((qp[:n_q, None, :] - p) ** 2).sum(-1)[gated])
    np.testing.assert_allclose(d2_t[gated], d2_j[gated], atol=2e-4)
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
    lab_t, pick_t = TFT.select_rings(_t(curv), _t(gap), _t(pre), _t(n), cfg)
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


def test_walk_bits_roundtrip():
    rng = np.random.default_rng(1)
    m = torch.tensor(rng.uniform(size=(3, 128)) < 0.3)
    words = TSW.pack_bits(m)
    assert int(words.max()) < 2 ** 32
    assert torch.equal(TSW.unpack_bits(words, 128), m)
