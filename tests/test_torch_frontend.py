"""loam_tpu_torch leaf math, ingest and feature extraction against
loam_tpu on the same seeded NumPy inputs (CPU, plain kernel versions).

Tolerances: integer outputs (ring ids, masks, labels, voxel keys) and
pure gathers must be identical.  Transcendentals (sin, atan2, acos) of
XLA:CPU and PyTorch differ by an ulp or two, and the two libraries' cumsum
reductions group additions differently, so float results that pass
through them get a bound stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF
from loam_tpu.ops import compact as JC, deskew as JD, features as JFT
from loam_tpu.ops import residuals as JR, voxel as JV
from loam_tpu.types import Sweep as JSweep
from loam_tpu.utils import linalg as JL, rotations as JRot

from loam_tpu_torch import frontend as TF
from loam_tpu_torch.ops import compact as TC, deskew as TD, features as TFT
from loam_tpu_torch.ops import residuals as TR, voxel as TV
from loam_tpu_torch.types import PointCloud, Sweep
from loam_tpu_torch.utils import linalg as TL, rotations as TRot

from torch_parity import make_sweeps, parity_cfg, to_port_cfg

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def sweeps():
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(3)
    js = jax.vmap(lambda x, m: JF.ingest_sweep(x, m, cfg))(
        jnp.asarray(raw), jnp.asarray(msk))
    return cfg, raw, msk, js


def test_types_decode_ring_and_time():
    rel = np.array([0.0, -1e-4, 3.05, 15.099], np.float32)
    c = PointCloud(xyz=torch.zeros(4, 3), rel=_t(rel),
                   mask=torch.tensor([True, True, False, True]))
    assert c.count().item() == 3 and c.capacity == 4
    np.testing.assert_array_equal(c.ring().numpy(), [0, 0, 3, 15])
    np.testing.assert_array_equal(c.sweep_time(0.1).numpy(),
                                  10.0 * (rel - np.trunc(rel)))
    s = Sweep(xyz=torch.zeros(2, 16, 8, 3), rel=torch.zeros(2, 16, 8),
              mask=torch.zeros(2, 16, 8, dtype=torch.bool))
    assert s.flatten().xyz.shape == (2, 128, 3)


def test_rotation_algebra_matches():
    """YXZ Euler algebra within 1e-6 (XLA vs torch sin/cos/atan2 ulps)."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.uniform(-0.6, 0.6, (6,)).astype(np.float32)
               for _ in range(3))
    a[3:] *= 20
    pts = rng.uniform(-30, 30, (64, 3)).astype(np.float32)
    pairs = [
        (JRot.r_yxz(a[:3]), TRot.r_yxz(_t(a[:3]))),
        (JRot.accumulate_rotation(a[:3], b[:3]),
         TRot.accumulate_rotation(_t(a[:3]), _t(b[:3]))),
        (JRot.plugin_imu_rotation(a[:3], b[:3], c[:3]),
         TRot.plugin_imu_rotation(_t(a[:3]), _t(b[:3]), _t(c[:3]))),
        (JRot.transform_associate_to_map(a, b, c),
         TRot.transform_associate_to_map(_t(a), _t(b), _t(c))),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-6)
    np.testing.assert_allclose(
        _np(TRot.apply_pose(_t(a), _t(pts))),
        np.asarray(JRot.apply_pose(a, pts)), atol=1e-5)  # 30 m * 3e-7


def test_small_linalg_matches():
    """Closed-form 3x3 eigen, plane fit, 3x3 and 6x6 solves, degeneracy
    projector: the same op sequences, within float32 ulps (1e-5
    relative for the acos-based eigenvalues)."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(256, 5, 3)).astype(np.float32)
    pts[:, :, 2] *= 0.01                                   # near-planar
    cov = np.einsum("qki,qkj->qij", pts, pts).astype(np.float32) / 5
    wj, Vj = JL.eigh3x3(jnp.asarray(cov))
    wt, Vt = TL.eigh3x3(_t(cov))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-6)
    # eigenvectors up to sign
    dots = np.abs(np.einsum("qki,qki->qk", Vt.numpy(), np.asarray(Vj)))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    nj, dj = JL.fit_plane5(jnp.asarray(pts + 5.0))
    nt, dt = TL.fit_plane5(_t(pts + 5.0))
    # the 1 cm-thick patches 5 m out are ill-conditioned (cond(A) ~ 1e3):
    # an ulp of difference upstream moves a normal by up to ~1e-4 * 1e-3
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=5e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=5e-5)
    M = rng.normal(size=(32, 3, 3)).astype(np.float32) + 3 * np.eye(3,
                                                                  dtype=np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(TL.solve3x3(_t(M), _t(b)).numpy(),
                               np.asarray(JL.solve3x3(M, b)), rtol=1e-5,
                               atol=1e-6)
    A = rng.normal(size=(40, 6)).astype(np.float32)
    ata = (A.T @ A).astype(np.float32)
    atb = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(TL.solve_sym6(_t(ata), _t(atb)).numpy(),
                               np.asarray(JL.solve_sym6(ata, atb)),
                               rtol=1e-4, atol=1e-5)
    for thr in (1.0, 30.0):
        Pj, dgj = JL.degeneracy_projector(jnp.asarray(ata), thr)
        Pt, dgt = TL.degeneracy_projector(_t(ata), thr)
        assert bool(dgt) == bool(dgj)
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-5)


def test_residuals_and_jacobians_match():
    """Residual geometry within 1e-5; the closed-form Jacobians against
    jax.grad/jacfwd of the same functions within 1e-4 (m-scale points,
    float32 products in a different order)."""
    rng = np.random.default_rng(2)
    p, p1, p2, p3 = (rng.uniform(-10, 10, (128, 3)).astype(np.float32)
                     for _ in range(4))
    for j, t in ((JR.point_to_line(p, p1, p2),
                  TR.point_to_line(_t(p), _t(p1), _t(p2))),
                 (JR.plane_from_tripod(p1, p2, p3),
                  TR.plane_from_tripod(_t(p1), _t(p2), _t(p3)))):
        for a, b in zip(j, t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5)
    theta = np.array([0.05, -0.3, 0.02, 0.4, -0.1, 0.9], np.float32)
    coeffs = rng.normal(size=(128, 3)).astype(np.float32)
    s = rng.uniform(0, 1, 128).astype(np.float32)
    np.testing.assert_allclose(
        TD.transform_to_start(_t(p), _t(s), _t(theta)).numpy(),
        np.asarray(JD.transform_to_start(p, s, theta)), atol=1e-5)
    np.testing.assert_allclose(
        TD.transform_to_end(_t(p), _t(s), _t(theta)).numpy(),
        np.asarray(JD.transform_to_end(p, s, theta)), atol=1e-5)
    np.testing.assert_allclose(
        TR.odom_point_jacobians(_t(p), _t(theta)).numpy(),
        np.asarray(JR.odom_point_jacobians(jnp.asarray(p),
                                           jnp.asarray(theta))), atol=1e-4)
    np.testing.assert_allclose(
        TR.odom_jacobian_rows(_t(p), _t(coeffs), _t(theta)).numpy(),
        np.asarray(JR.odom_jacobian_rows(jnp.asarray(p), jnp.asarray(coeffs),
                                         jnp.asarray(theta))), atol=1e-4)
    np.testing.assert_allclose(
        TR.map_jacobian_rows(_t(p), _t(coeffs), _t(theta)).numpy(),
        np.asarray(JR.map_jacobian_rows(jnp.asarray(p), jnp.asarray(coeffs),
                                        jnp.asarray(theta))), atol=1e-4)


def test_compact_and_voxel_match():
    """Compaction is a pure gather (identical); voxel keys and counts are
    identical, centroids within 8 * N * leaf * eps32 (the two cumsums
    group additions differently over prefixes bounded by N * leaf)."""
    rng = np.random.default_rng(3)
    N = 1024
    xyz = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    mask = rng.uniform(size=N) < 0.7
    rel = rng.uniform(0, 16, N).astype(np.float32)
    (jx,), jok = JC.compact_masked(jnp.asarray(mask), (jnp.asarray(rel),), 1500)
    (tx,), tok = TC.compact_masked(_t(mask), (_t(rel),), 1500)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tx.numpy()[tok.numpy()],
                                  np.asarray(jx)[np.asarray(jok)])
    for leaf in (0.2, 0.4, 2.0):
        jo = JV.voxel_downsample(jnp.asarray(xyz), jnp.asarray(mask), leaf,
                                 N, extra=jnp.asarray(rel))
        to = TV.voxel_downsample(_t(xyz), _t(mask), leaf, N, extra=_t(rel))
        tol = 8 * N * leaf * np.finfo(np.float32).eps
        np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]))
        np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]),
                                   atol=tol)
        np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]),
                                   atol=1e-5)
    vox = rng.integers(-40000, 40000, (64, 3))
    jh, jl = JV.pack_coords2(jnp.asarray(vox, jnp.int32))
    th, tl = TV.pack_coords2(_t(vox))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl).astype(np.int64))


def test_ingest_sweep_matches(sweeps):
    """Ring ids, ring-major order and masks identical; rel within 2e-6
    (atan2 ulps and the cumsum-based unwrap over ~8k points)."""
    cfg, raw, msk, js = sweeps
    ts = TF.ingest_sweep(_t(raw), _t(msk), to_port_cfg(cfg))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(ts.xyz.numpy(), np.asarray(js.xyz))
    np.testing.assert_allclose(ts.rel.numpy(), np.asarray(js.rel), atol=2e-6)
    np.testing.assert_array_equal(np.trunc(ts.rel.numpy()),
                                  np.trunc(np.asarray(js.rel)))


def test_selection_labels_match_select_ring(sweeps):
    """The port's walk labels on real sweeps equal the JAX default
    select_ring, ring by ring."""
    cfg, _, _, js = sweeps
    tsw = Sweep(_t(js.xyz), _t(js.rel), _t(js.mask))
    tcfg = to_port_cfg(cfg)
    curv, gap, pre, counts = TFT.selection_inputs(tsw, tcfg)
    W = cfg.ring_width
    lab_t, _ = TFT.select_rings(curv.reshape(-1, W), gap.reshape(-1, W),
                                pre.reshape(-1, W), counts.reshape(-1), tcfg)
    S = cfg.n_scans
    lab_j, _ = jax.vmap(
        lambda x, c, g, p, n: JFT.select_ring(x, c, g, p, n, cfg)
    )(jnp.asarray(js.xyz).reshape(-1, W, 3),
      jnp.asarray(curv.numpy()).reshape(-1, W),
      jnp.asarray(gap.numpy()).reshape(-1, W),
      jnp.asarray(pre.numpy()).reshape(-1, W),
      jnp.asarray(counts.numpy()).reshape(-1))
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    assert (lab_t.numpy() == 2).sum() >= S


def test_extract_features_matches(sweeps):
    """Three frames from the same Sweep: sharp, less-sharp, flat and full
    clouds identical; less-flat masks identical and points within 1e-5
    m / rel within 1e-5 (per-ring voxel centroids via cumsum)."""
    cfg, _, _, js = sweeps
    jf = jax.vmap(lambda s: JFT.extract_features(s, cfg))(
        JSweep(js.xyz, js.rel, js.mask))
    tf = TFT.extract_features(Sweep(_t(js.xyz), _t(js.rel), _t(js.mask)),
                              to_port_cfg(cfg))
    for name in ("sharp", "less_sharp", "flat", "full", "less_flat"):
        a, b = getattr(jf, name), getattr(tf, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        if name == "less_flat":
            np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz),
                                       atol=1e-5)
            np.testing.assert_allclose(b.rel.numpy(), np.asarray(a.rel),
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(b.xyz.numpy(), np.asarray(a.xyz))
            np.testing.assert_array_equal(b.rel.numpy(), np.asarray(a.rel))
    assert (tf.sharp.count() > 0).all() and (tf.flat.count() > 0).all()


@pytest.mark.parametrize("field,value", [("select_argmax", True),
                                         ("corner_scan_k", 10)])
def test_unported_selection_configs_raise(field, value):
    """Both selection knobs are ported: each runs alone, and the two
    together raise the ValueError that the JAX package asserts
    (loam_tpu/ops/features.py:665-668), before any work is done."""
    cfg = to_port_cfg(dataclasses.replace(parity_cfg(), **{field: value}))
    s = Sweep(torch.zeros(1, 16, 512, 3), torch.zeros(1, 16, 512),
              torch.zeros(1, 16, 512, dtype=torch.bool))
    assert TFT.extract_features(s, cfg).sharp.count().item() == 0
    both = dataclasses.replace(cfg, select_argmax=True, corner_scan_k=10)
    with pytest.raises(ValueError, match="incompatible"):
        TFT.extract_features(s, both)
