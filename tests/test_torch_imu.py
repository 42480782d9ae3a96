"""loam_tpu_torch's IMU path against loam_tpu on the same seeded NumPy
inputs (CPU, plain kernel versions).

Tolerances: imu_from_raw, rpy_at, sweep_state and imu_trans 1e-6
(sin/cos ulps of XLA:CPU and PyTorch); integrate rtol 1e-5 / atol 1e-7,
the bound set for jnp.cumsum against torch.cumsum (the port's
numerics.cumsum now groups as XLA:CPU does; the rotated accelerations
still differ by ulps); deskewed points 1e-5 m (30 m x 3e-7).  Integer
outputs, masks, sweep times and feature labels must be identical.
Replays are held per frame to rot 1e-4 rad / trans 1e-3 m, the bounds
of test_torch_pipeline.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, imu as JI, mapping as JMap
from loam_tpu import odometry as JO, pipeline as JP
from loam_tpu.ops import deskew as JD, features as JFT
from loam_tpu.types import ImuTrans as JImuTrans, Sweep as JSweep

from loam_tpu_torch import frontend as TF, imu as TI, mapping as TMap
from loam_tpu_torch import odometry as TO, pipeline as TP
from loam_tpu_torch.io import synth
from loam_tpu_torch.ops import deskew as TD, features as TFT
from loam_tpu_torch.state import (imu_stream_from_numpy, imu_trans_from_numpy,
                                  pipeline_state_from_numpy)
from loam_tpu_torch.types import PointCloud, Sweep
from loam_tpu_torch.utils import numerics

from torch_parity import (cloud_to_torch, feats_to_torch, make_sweeps,
                          parity_cfg, pose_errors, to_port_cfg,
                          tree_to_numpy)

torch.set_num_threads(1)

STREAM_FIELDS = ("t", "rpy", "acc", "mask")
T0 = 0.06        # first sweep stamp, as in tests/test_golden_parity_imu.py


def _t(a):
    return torch.tensor(np.asarray(a))


def _jstream(tree):
    return JI.ImuStream(**{k: jnp.asarray(v) for k, v in tree.items()})


def _frame(tree, k):
    return {n: v[k] for n, v in tree.items()}


def _frames(tree, k):
    """The first k frames' windows."""
    return {n: v[:k] for n, v in tree.items()}


def _windows(pose_fn, t_scans, **kw):
    """Per-frame IMU windows from synth.simulate_imu_window, stacked as
    an ImuStream tree of NumPy arrays with a leading frame axis."""
    ws = [synth.simulate_imu_window(pose_fn, t0=float(t), **kw)
          for t in t_scans]
    return {n: np.stack([w[i] for w in ws])
            for i, n in enumerate(STREAM_FIELDS)}


def _oscillating_sweeps(frames, n_azimuth=480, seed=11):
    """Raw sweeps along synth.oscillating_trajectory with their IMU
    windows and sweep stamps (tests/test_golden_parity_imu.py's
    scenario, shortened)."""
    world = synth.make_world(seed=seed)
    pose_fn = synth.oscillating_trajectory()
    t_scans = T0 + 0.1 * np.arange(frames)
    sweeps = [synth.simulate_sweep_traj(world, pose_fn, t0=float(t),
                                        n_azimuth=n_azimuth, seed=seed + k)
              for k, t in enumerate(t_scans)]
    raw = np.stack([s[0] for s in sweeps])
    msk = np.stack([s[1] for s in sweeps])
    return (raw, msk, _windows(pose_fn, t_scans),
            t_scans.astype(np.float32), pose_fn)


def _assert_tree_close(port, jax_obj, **tol):
    jt = tree_to_numpy(jax_obj)
    for name, val in tree_to_numpy(port).items():
        if val.dtype == bool:
            np.testing.assert_array_equal(val, jt[name], err_msg=name)
        else:
            np.testing.assert_allclose(val, jt[name], err_msg=name, **tol)


@pytest.fixture(scope="module")
def streams():
    """Three frames' windows: the oscillating trajectory, a yaw that
    crosses +-pi inside the window (the unwrap), and a window with one
    valid sample (no IMU state)."""
    pose_fn = synth.oscillating_trajectory()
    tree = _windows(pose_fn, T0 + 0.1 * np.arange(3))
    t1 = tree["t"][1].astype(np.float64)
    tree["rpy"][1, :, 1] = np.angle(np.exp(1j * (2.9 + 3.0 * (t1 - t1[0]))))
    tree["mask"][2, 1:] = False
    assert np.ptp(tree["rpy"][1, tree["mask"][1], 1]) > 6.0
    return tree


@pytest.mark.parametrize("shape,axis", [((5,), 0), ((3, 64), -1),
                                        ((2, 4097), 1), ((600, 3), 0)])
def test_numerics_match_xla_cpu(shape, axis):
    """numerics.cumsum groups its additions as XLA:CPU's jnp.cumsum does
    and numerics.fma rounds c + b * a once, as XLA:CPU's contracted
    multiply-add in a fused loop: both equal bit for bit (the azimuth
    unwrap, the sweep time and the IMU integration rest on them)."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.normal(0, 1e-2, shape).astype(np.float32)
    np.testing.assert_array_equal(
        numerics.cumsum(_t(x), axis).numpy(),
        np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis))(x)))
    c = rng.integers(0, 16, shape).astype(np.float32)
    np.testing.assert_array_equal(
        numerics.fma(_t(x), 0.1, _t(c)).numpy(),
        np.asarray(jax.jit(lambda a, b: b + 0.1 * a)(x, c)))


def test_imu_from_raw_matches():
    rng = np.random.default_rng(0)
    F, M = 3, 64
    t = np.sort(rng.uniform(0, 1, (F, M)), -1).astype(np.float32)
    quat_rpy = rng.uniform(-0.5, 0.5, (F, M, 3)).astype(np.float32)
    acc = rng.normal(0, 2, (F, M, 3)).astype(np.float32)
    mask = np.arange(M) < np.array([[64], [40], [1]])
    ts = TI.imu_from_raw(_t(t), _t(quat_rpy), _t(acc), _t(mask))
    for k in range(F):
        js = JI.imu_from_raw(jnp.asarray(t[k]), jnp.asarray(quat_rpy[k]),
                             jnp.asarray(acc[k]), jnp.asarray(mask[k]))
        _assert_tree_close(ts.map(lambda x: x[k]), js, atol=1e-6, rtol=0)


def _stream(t, acc, mask):
    cap = t.shape[0]
    return {"t": t, "rpy": np.zeros((cap, 3), np.float32), "acc": acc,
            "mask": mask}


def _constant_acceleration():
    n, cap, dt = 40, 64, 0.005
    t = np.zeros(cap, np.float32)
    t[:n] = np.arange(n) * dt
    acc = np.zeros((cap, 3), np.float32)
    acc[:n] = [0.0, 0.0, 2.0]
    return _stream(t, acc, np.arange(cap) < n)


def _gap():
    t = np.array([0.0, 0.01, 0.5, 0.51, 0, 0, 0, 0], np.float32)
    acc = np.zeros((8, 3), np.float32)
    acc[:4] = [0.0, 0.0, 1.0]
    return _stream(t, acc, np.arange(8) < 4)


@pytest.mark.parametrize("case", ["batch", "constant_acceleration", "gap"])
def test_integrate_matches(case, streams):
    """tests/test_imu.py's closed forms hold in the port, and each window
    agrees with loam_tpu.imu.integrate; "batch" integrates three frames in
    one port call against three JAX calls."""
    cfg = parity_cfg()
    tree = {"batch": streams, "constant_acceleration": _constant_acceleration(),
            "gap": _gap()}[case]
    integ = TI.integrate(imu_stream_from_numpy(tree, device="cpu"),
                         to_port_cfg(cfg))
    frames = range(3) if case == "batch" else [None]
    for k in frames:
        sub = tree if k is None else _frame(tree, k)
        ji = JI.integrate(_jstream(sub), cfg)
        pi = integ if k is None else TI.ImuIntegral(integ.velo[k],
                                                     integ.shift[k])
        _assert_tree_close(pi, ji, rtol=1e-5, atol=1e-7)
    v, s = integ.velo.numpy(), integ.shift.numpy()
    if case == "constant_acceleration":
        tt = tree["t"][39]
        np.testing.assert_allclose(v[39], [0, 0, 2.0 * tt], atol=1e-4)
        np.testing.assert_allclose(s[39, 2], tt * tt, atol=2.0 * tt * 0.005)
    elif case == "gap":
        assert v[2, 2] == v[1, 2] and v[3, 2] > v[2, 2]
        np.testing.assert_array_equal(v[4:], np.broadcast_to(v[3], (4, 3)))


def _sweep_inputs(shape=(3, 4, 40), seed=1):
    """Sorted per-point sweep fractions with a fifth of the points
    masked; frame 0 has several valid points at fraction 0 (an argmin
    tie: the first index wins) and a masked one before them."""
    rng = np.random.default_rng(seed)
    rel = np.sort(rng.uniform(0, 1, shape), -1).astype(np.float32)
    mask = rng.uniform(size=shape) < 0.8
    rel[0, :, 0] = 0.0
    mask[0, 0, 0] = False
    return rel, mask


def test_sweep_state_rpy_at_deskew_imu_trans_match(streams):
    """Three frames (oscillating, a yaw crossing +-pi, one valid sample)
    in one port call against three JAX calls: every SweepImu field and
    rpy_at within 1e-6, valid equal, deskewed points within 1e-5 m,
    ImuTrans within 1e-6."""
    cfg = parity_cfg()
    tcfg = to_port_cfg(cfg)
    rel, pmask = _sweep_inputs()
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-30, 30, rel.shape + (3,)).astype(np.float32)
    t_scans = (T0 + 0.1 * np.arange(3)).astype(np.float32)
    ts = imu_stream_from_numpy(streams, device="cpu")
    tinteg = TI.integrate(ts, tcfg)
    tsw = TI.sweep_state(ts, tinteg, _t(t_scans), _t(rel), _t(pmask), tcfg)
    tdesk = TI.deskew_points(_t(xyz), tsw)
    ttrans = TI.imu_trans(tsw)
    t_end = t_scans + np.float32(0.1)
    trpy, tok = TI.rpy_at(ts, _t(t_end))
    np.testing.assert_array_equal(tsw.valid.numpy(), [True, True, False])
    for k in range(3):
        js = _jstream(_frame(streams, k))
        jsw = JI.sweep_state(js, JI.integrate(js, cfg), jnp.float32(t_scans[k]),
                             jnp.asarray(rel[k]), jnp.asarray(pmask[k]), cfg)
        pick = lambda x: x[k]
        _assert_tree_close(dataclasses.replace(
            tsw, **{f.name: pick(getattr(tsw, f.name))
                    for f in dataclasses.fields(tsw)}), jsw, atol=1e-6,
            rtol=0)
        np.testing.assert_allclose(
            tdesk[k].numpy(),
            np.asarray(JI.deskew_points(jnp.asarray(xyz[k]), jsw)), atol=1e-5)
        _assert_tree_close(ttrans.map(pick), JI.imu_trans(jsw), atol=1e-6,
                           rtol=0)
        jrpy, jok = JI.rpy_at(js, jnp.float32(t_end[k]))
        np.testing.assert_allclose(trpy[k].numpy(), np.asarray(jrpy),
                                   atol=1e-6)
        assert bool(tok[k]) == bool(jok)
    # the unwrap: between samples on either side of +-pi, frame 1's yaw
    # is interpolated the short way round (never through 0)
    yaw = tsw.rpy_pt[1, ..., 1].numpy().ravel()
    assert np.abs(yaw).max() > 3.1 and np.abs(yaw).min() > 2.9
    # one valid sample: no IMU state, a zero ImuTrans
    for f in dataclasses.fields(ttrans):
        assert torch.equal(getattr(ttrans, f.name)[2], torch.zeros(3))


def test_transform_to_end_imu_tail_matches():
    """The IMU tail against loam_tpu within 1e-5 m; without the IMU
    arguments the result is the tail at zero angles and shift, exactly
    (the tail is the identity there)."""
    rng = np.random.default_rng(3)
    p = rng.uniform(-30, 30, (256, 3)).astype(np.float32)
    s = rng.uniform(0, 1, 256).astype(np.float32)
    theta = np.array([0.03, -0.2, 0.01, 0.3, -0.05, 0.8], np.float32)
    imu = [rng.uniform(-0.3, 0.3, 3).astype(np.float32) for _ in range(2)]
    shift = np.array([0.02, -0.01, 0.05], np.float32)
    out = TD.transform_to_end(_t(p), _t(s), _t(theta), _t(imu[0]),
                              _t(imu[1]), _t(shift))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(JD.transform_to_end(p, s, theta, imu[0],
                                                    imu[1], shift)),
        atol=1e-5)
    plain = TD.transform_to_end(_t(p), _t(s), _t(theta))
    z = torch.zeros(3)
    assert torch.equal(plain, TD.transform_to_end(_t(p), _t(s), _t(theta),
                                                  z, z, z))
    assert (out - plain).abs().max() > 0.1


IMU_TRANS = {"rpy_start": [0.02, 0.1, -0.015], "rpy_cur": [0.025, 0.11, -0.01],
             "shift_from_start": [0.01, -0.005, 0.02],
             "velo_from_start": [0.05, 0.0, -0.1]}


@pytest.fixture(scope="module")
def odom_mid_run():
    """JAX state after frames 0-1 and the JAX features of frame 2
    (test_torch_odometry's inputs), with a non-zero ImuTrans."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(3, seed=5)
    _, st = JP.replay_sweeps(jnp.asarray(raw[:2]), jnp.asarray(msk[:2]), cfg,
                             return_state=True)
    feats = JFT.extract_features(
        JF.ingest_sweep(jnp.asarray(raw[2]), jnp.asarray(msk[2]), cfg), cfg)
    tree = {k: np.array(v, np.float32) for k, v in IMU_TRANS.items()}
    return cfg, st, feats, tree


def test_odometry_step_imu_matches(odom_mid_run):
    """A solve frame with an ImuTrans: the velocity prior, the drift and
    the rotation plug-in show in the pose, which matches loam_tpu within
    rot 1e-4 rad / trans 1e-3 m; the end-projected clouds (IMU tail)
    within 1e-5 m."""
    cfg, st, feats, tree = odom_mid_run
    jimu = JImuTrans(**{k: jnp.asarray(v) for k, v in tree.items()})
    _, jout = JO.odometry_step(st.odom, feats, jimu, cfg)
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    tfeats = feats_to_torch(feats)
    tcfg = to_port_cfg(cfg)
    _, tout = TO.odometry_step(tstate.odom, tfeats, tcfg,
                               imu=imu_trans_from_numpy(tree, device="cpu"))
    rot, trans = pose_errors(tout.pose.numpy(), jout.pose)
    assert rot < 1e-4 and trans < 1e-3, (rot, trans)
    for name in ("corner_last", "surf_last"):
        a, b = getattr(jout, name), getattr(tout, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz),
                                   atol=1e-5)
    _, plain = TO.odometry_step(tstate.odom, tfeats, tcfg)
    assert np.abs(tout.pose.numpy() - plain.pose.numpy()).max() > 5e-3


def test_odometry_init_and_unsolvable_frames_imu(odom_mid_run):
    """The init frame seeds transformSum's pitch and roll with the IMU
    start attitude; a frame that cannot solve keeps the velocity prior
    as its transform.  Both against loam_tpu."""
    cfg, _, feats, tree = odom_mid_run
    tcfg = to_port_cfg(cfg)
    jimu = JImuTrans(**{k: jnp.asarray(v) for k, v in tree.items()})
    timu = imu_trans_from_numpy(tree, device="cpu")
    tfeats = feats_to_torch(feats)
    s0 = TO.OdomState.create(tcfg, device="cpu")
    s1, out = TO.odometry_step(s0, tfeats, tcfg, imu=timu)
    j1, jout = JO.odometry_step(JO.OdomState.create(cfg), feats, jimu, cfg)
    r = tree["rpy_start"]
    np.testing.assert_array_equal(out.pose.numpy(),
                                  [r[0], 0, r[2], 0, 0, 0])
    np.testing.assert_array_equal(out.pose.numpy(), np.asarray(jout.pose))
    assert not bool(out.publish_to_mapping)
    empty = dataclasses.replace(s1, corner_last=s0.corner_last)
    s2, out2 = TO.odometry_step(empty, tfeats, tcfg, imu=timu)
    jempty = dataclasses.replace(j1, corner_last=JO.OdomState.create(
        cfg).corner_last)
    j2, jout2 = JO.odometry_step(jempty, feats, jimu, cfg)
    np.testing.assert_allclose(
        s2.transform.numpy(),
        np.r_[0, 0, 0, -tree["velo_from_start"] * np.float32(0.1)],
        rtol=0, atol=0)
    np.testing.assert_array_equal(s2.transform.numpy(),
                                  np.asarray(j2.transform))
    rot, trans = pose_errors(out2.pose.numpy(), jout2.pose)
    assert rot < 1e-4 and trans < 1e-3, (rot, trans)
    jax.clear_caches()


@pytest.fixture(scope="module")
def map_mid_run():
    """JAX state after frames 0-2 and the odometry output of frame 3
    (test_torch_mapping's inputs)."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(4, seed=7)
    _, st = JP.replay_sweeps(jnp.asarray(raw[:3]), jnp.asarray(msk[:3]), cfg,
                             return_state=True)
    feats = JFT.extract_features(
        JF.ingest_sweep(jnp.asarray(raw[3]), jnp.asarray(msk[3]), cfg), cfg)
    _, odom_out = JO.odometry_step(st.odom, feats, None, cfg)
    return cfg, st, odom_out


def _port_mapping(st, odom_out, cfg, imu_rpy=None, fresh=False):
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    tcfg = to_port_cfg(cfg)
    mstate = TMap.MapState.create(tcfg, device="cpu") if fresh else tstate.map
    return TMap.mapping_step(
        mstate, _t(odom_out.pose),
        cloud_to_torch(odom_out.corner_last, PointCloud),
        cloud_to_torch(odom_out.surf_last, PointCloud), tcfg,
        imu_rpy=None if imu_rpy is None else _t(imu_rpy))


@pytest.mark.parametrize("case", ["valid", "not_ok", "cannot_solve"])
def test_mapping_step_imu_blend(case, map_mid_run):
    """The 0.998/0.002 roll/pitch blend of transformUpdate: applied on a
    solved frame with ok = 1 (against loam_tpu's jitted mapping_step
    within the replay bounds, rot 1e-4 rad / trans 1e-3 m: XLA fuses the
    Gauss-Newton body, test_torch_mapping.py; and exactly the blend of
    the port's own unblended pose), not applied with ok = 0, and on a
    frame that cannot solve (an empty map) transform_bef / transform_aft
    keep their old values."""
    cfg, st, odom_out = map_mid_run
    pose = np.asarray(odom_out.pose)
    imu_rpy = np.array([pose[0] + 0.4, pose[2] - 0.3,
                        0.0 if case == "not_ok" else 1.0], np.float32)
    fresh = case == "cannot_solve"
    tnew, tout = _port_mapping(st, odom_out, cfg, imu_rpy, fresh=fresh)
    _, plain = _port_mapping(st, odom_out, cfg, fresh=fresh)
    if case == "valid":
        _, jout = JMap.mapping_step(
            st.map, odom_out.pose, odom_out.corner_last,
            odom_out.surf_last, jnp.asarray(imu_rpy), cfg)
        assert bool(tout.solved) and bool(jout.solved)
        rot, trans = pose_errors(tout.pose_aft.numpy(), jout.pose_aft)
        assert rot < 1e-4 and trans < 1e-3, (rot, trans)
        a, p = tout.pose_aft.numpy(), plain.pose_aft.numpy()
        np.testing.assert_allclose(
            a[[0, 2]], 0.998 * p[[0, 2]] + 0.002 * imu_rpy[:2], atol=1e-7)
        np.testing.assert_array_equal(a[[1, 3, 4, 5]], p[[1, 3, 4, 5]])
        assert np.abs(a - p).max() > 5e-4
    elif case == "not_ok":
        assert bool(tout.solved)
        assert torch.equal(tout.pose_aft, plain.pose_aft)
    else:
        _, jout = JMap.mapping_step(
            JMap.MapState.create(cfg), odom_out.pose, odom_out.corner_last,
            odom_out.surf_last, jnp.asarray(imu_rpy), cfg)
        assert not bool(tout.solved) and not bool(jout.solved)
        assert torch.equal(tnew.transform_aft, torch.zeros(6))
        assert torch.equal(tnew.transform_bef, torch.zeros(6))
        np.testing.assert_array_equal(tout.pose_aft.numpy(),
                                      np.asarray(jout.pose_aft))


@pytest.fixture(scope="module")
def ingested():
    """Three oscillating sweeps ingested with their IMU windows by both
    packages (JAX: one ingest_sweep_imu per frame, vmapped)."""
    cfg = parity_cfg()
    raw, msk, tree, t_scans, _ = _oscillating_sweeps(3)
    js = _jstream(tree)
    jinteg = jax.vmap(lambda s: JI.integrate(s, cfg))(js)
    jsw, jtrans = jax.vmap(
        lambda x, m, s, g, t: JF.ingest_sweep_imu(x, m, cfg, s, g, t)
    )(jnp.asarray(raw), jnp.asarray(msk), js, jinteg, jnp.asarray(t_scans))
    return cfg, raw, msk, tree, t_scans, jsw, jtrans


def test_ingest_sweep_imu_matches(ingested):
    """rel and mask identical, deskewed xyz within 1e-5 m, ImuTrans
    within 1e-6; the deskew moved points (against the no-IMU ingest)."""
    cfg, raw, msk, tree, t_scans, jsw, jtrans = ingested
    tcfg = to_port_cfg(cfg)
    ts = imu_stream_from_numpy(tree, device="cpu")
    tsw, ttrans = TF.ingest_sweep_imu(_t(raw), _t(msk), tcfg, ts,
                                      TI.integrate(ts, tcfg), _t(t_scans))
    np.testing.assert_array_equal(tsw.mask.numpy(), np.asarray(jsw.mask))
    np.testing.assert_array_equal(tsw.rel.numpy(), np.asarray(jsw.rel))
    np.testing.assert_allclose(tsw.xyz.numpy(), np.asarray(jsw.xyz),
                               atol=1e-5)
    _assert_tree_close(ttrans, jtrans, atol=1e-6, rtol=0)
    plain = TF.ingest_sweep(_t(raw), _t(msk), tcfg)
    assert torch.equal(plain.rel, tsw.rel)
    assert (plain.xyz - tsw.xyz).abs().max() > 1e-3
    zero, _ = TF.ingest_sweep_imu(_t(raw), _t(msk), tcfg)
    assert torch.equal(zero.xyz, plain.xyz)


def test_extract_features_on_deskewed_sweep(ingested):
    """The port's feature extraction on the JAX-deskewed sweeps gives
    loam_tpu's labels: sharp, less-sharp, flat and full clouds identical,
    less-flat masks identical and points within 1e-5 m (per-ring voxel
    centroids via cumsum), as test_torch_frontend holds them."""
    cfg, _, _, _, _, jsw, _ = ingested
    jf = jax.vmap(lambda s: JFT.extract_features(s, cfg))(
        JSweep(jsw.xyz, jsw.rel, jsw.mask))
    tf = TFT.extract_features(Sweep(_t(jsw.xyz), _t(jsw.rel),
                                    _t(jsw.mask)), to_port_cfg(cfg))
    for name in ("sharp", "less_sharp", "flat", "full", "less_flat"):
        a, b = getattr(jf, name), getattr(tf, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        tol = dict(atol=1e-5) if name == "less_flat" else dict(atol=0,
                                                                  rtol=0)
        np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz), **tol)
        np.testing.assert_allclose(b.rel.numpy(), np.asarray(a.rel), **tol)
    assert (tf.sharp.count() > 0).all() and (tf.flat.count() > 0).all()


FRAMES = 7


@pytest.fixture(scope="module")
def imu_replays():
    cfg = parity_cfg()
    tcfg = to_port_cfg(cfg)
    raw, msk, tree, t_scans, _ = _oscillating_sweeps(FRAMES)
    jouts = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg,
                             _jstream(tree), jnp.asarray(t_scans))
    touts = TP.replay_sweeps(raw, msk, tcfg,
                             imu_stream_from_numpy(tree, device="cpu"),
                             t_scans, device="cpu")
    plain = TP.replay_sweeps(raw, msk, tcfg, device="cpu")
    return cfg, raw, msk, tree, t_scans, jouts, touts, plain


TEACHER_FRAMES = (1, 3, 5)   # the replay's mapping frames


def test_imu_replay_matches_loam_tpu(imu_replays):
    """Seven oscillating sweeps with their IMU windows against
    loam_tpu.pipeline.replay_sweeps with the same streams: the cadence is
    identical, the IMU moves the port's own trajectory off its no-IMU
    replay, and pose_odom holds per frame at rot 1e-4 / trans 1e-3.

    The mapping poses are held teacher-forced, one step at a time: for
    each mapping frame k, loam_tpu's (jitted) state before frame k is
    carried into the port, and frame k's features, ImuTrans and sweep-end
    attitude (loam_tpu's) go through the port's pipeline_step and through
    loam_tpu's pipeline_step run op by op (jax.disable_jit).  pose_aft,
    pose_integrated and pose_odom agree within 1e-6 rad / 1e-5 m; the
    step's pose_odom also holds against loam_tpu's jitted step at
    1e-4 / 1e-3.  A whole-replay bound on the mapping poses is not
    used: the first solving mapping frame of this scenario amplifies
    rounding ~1000-fold, and loam_tpu's jitted replay differs from its
    own op-by-op replay by 3.8e-4 rad / 2.1e-3 m at frames 5-6."""
    cfg, raw, msk, tree, t_scans, jouts, touts, plain = imu_replays
    np.testing.assert_array_equal(touts.mapped.numpy(),
                                  np.asarray(jouts.mapped))
    est = touts.pose_integrated.numpy()
    assert np.isfinite(est).all()
    diff = np.abs(est[:, 3:] - plain.pose_integrated.numpy()[:, 3:]).max()
    assert diff > 1e-3, diff
    odom = [pose_errors(touts.pose_odom.numpy()[k],
                        np.asarray(jouts.pose_odom)[k])
            for k in range(FRAMES)]
    assert all(r < 1e-4 and t < 1e-3 for r, t in odom), odom

    tcfg = to_port_cfg(cfg)
    js = _jstream(tree)
    jsw, jtrans = jax.vmap(
        lambda x, m, s, g, t: JF.ingest_sweep_imu(x, m, cfg, s, g, t)
    )(jnp.asarray(raw), jnp.asarray(msk), js,
      jax.vmap(lambda s: JI.integrate(s, cfg))(js), jnp.asarray(t_scans))
    jfeats = jax.vmap(lambda s: JFT.extract_features(s, cfg))(jsw)

    def map_rpy(s, t):
        rpy, ok = JI.rpy_at(s, t + cfg.scan_period)
        return jnp.stack([rpy[0], rpy[2], ok.astype(jnp.float32)])

    jrpy = jax.vmap(map_rpy)(js, jnp.asarray(t_scans))
    names = ("pose_odom", "pose_aft", "pose_integrated")
    over = []
    for k in TEACHER_FRAMES:
        assert bool(np.asarray(jouts.mapped)[k])
        _, jstate = JP.replay_sweeps(
            jnp.asarray(raw[:k]), jnp.asarray(msk[:k]), cfg,
            _jstream(_frames(tree, k)), jnp.asarray(t_scans[:k]),
            return_state=True)
        f_k = jax.tree_util.tree_map(lambda a: a[k], jfeats)
        trans_k = jax.tree_util.tree_map(lambda a: a[k], jtrans)
        _, jit_out = jax.jit(
            lambda s, f, i, r: JP.pipeline_step(s, f, i, cfg, map_rpy=r)
        )(jstate, f_k, trans_k, jrpy[k])
        with jax.disable_jit():
            _, op_out = JP.pipeline_step(jstate, f_k, trans_k, cfg,
                                         map_rpy=jrpy[k])
        tstate = pipeline_state_from_numpy(tree_to_numpy(jstate),
                                           device="cpu")
        _, tout = TP.pipeline_step(
            tstate, feats_to_torch(f_k), tcfg,
            imu=imu_trans_from_numpy(tree_to_numpy(trans_k), device="cpu"),
            map_rpy=_t(jrpy[k]))
        assert bool(tout.mapped) and bool(op_out.mapped)
        for name in names:
            rot, trans = pose_errors(getattr(tout, name).numpy(),
                                     np.asarray(getattr(op_out, name)))
            if not (rot < 1e-6 and trans < 1e-5):
                over.append((k, name, "op-by-op", rot, trans))
        rot, trans = pose_errors(tout.pose_odom.numpy(),
                                 np.asarray(jit_out.pose_odom))
        if not (rot < 1e-4 and trans < 1e-3):
            over.append((k, "pose_odom", "jitted", rot, trans))
    assert not over, over


def test_replay_features_imu(imu_replays):
    """replay_features with the ImuTrans replays the odometry of
    replay_sweeps exactly, with the same cadence (it has no sweep-end IMU
    attitude, so no mapping blend, as in loam_tpu); with_imu=False drops
    the priors."""
    cfg, raw, msk, tree, t_scans, _, touts, _ = imu_replays
    tcfg = to_port_cfg(cfg)
    sweeps, trans, _ = TP.ingest_frames(
        _t(raw), _t(msk), tcfg, imu_stream_from_numpy(tree, device="cpu"),
        t_scans)
    feats = TFT.extract_features(sweeps, tcfg)
    fouts = TP.replay_features(feats, tcfg, trans, with_imu=True,
                               device="cpu")
    assert torch.equal(fouts.pose_odom, touts.pose_odom)
    assert torch.equal(fouts.mapped, touts.mapped)
    no_imu = TP.replay_features(feats, tcfg, trans, device="cpu")
    assert (no_imu.pose_odom - fouts.pose_odom).abs().max() > 1e-3


def test_imu_inputs_checked():
    """A window needs two sample slots; streams and stamps go together;
    the IMU carriers run on the card unless asked."""
    with pytest.raises(ValueError, match="M >= 2"):
        TI.ImuStream.zeros(1)
    cfg = to_port_cfg(parity_cfg())
    with pytest.raises(ValueError, match="together"):
        TP.replay_sweeps(torch.zeros(1, 64, 3),
                         torch.zeros(1, 64, dtype=torch.bool), cfg,
                         TI.ImuStream.zeros(8), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            imu_stream_from_numpy(tree_to_numpy(TI.ImuStream.zeros(8)))
