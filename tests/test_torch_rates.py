"""loam_tpu_torch at the VLP-16's other rotation rates (scan_period 0.05 s
and 0.2 s: 1200 and 300 RPM) against loam_tpu at 0.1 s (CPU, plain
kernel versions).

The frontend encodes a point's time as rel = ring + scan_period *
rel_time.  loam_tpu decodes it as s = 10 * frac(rel), the C++'s fixed
1 / 0.1 s (src/laserOdometry.cpp:103), so at another period its deskew
scales s by 10 * scan_period; the port decodes s = frac(rel) /
scan_period = rel_time.  Without an IMU scan_period reaches the
trajectory only through that pair, so loam_tpu at 0.1 s on the same raw
sweeps is the reference semantics at any rate.  The two encodings of rel
differ by about a float32 ulp of the ring id (up to 15), so the gates are
not bit-equality: the decode within 2e-5 (that ulp times 1 / 0.05 s), a
teacher-forced odometry step within 1e-5 rad / 1e-4 m, a whole 5-frame
replay within 1e-4 rad / 1e-3 m (the bounds of test_torch_pipeline.py).
At 0.2 s the sweeps move twice as far and the first solving mapping frame
of these 5-frame replays is ill-conditioned (ROADMAP.md section 3): the
port at 0.1 s, encoded exactly as loam_tpu, misses loam_tpu's mapping
poses there by up to 5.0e-4 rad / 2.1e-3 m, so at 0.2 s the replay is
held on its odometry poses and cadence and the step teacher-forced.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, imu as JI, odometry as JO
from loam_tpu import pipeline as JP
from loam_tpu.ops.features import extract_features as j_extract

from loam_tpu_torch import frontend as TF, imu as TI, odometry as TO
from loam_tpu_torch import pipeline as TP
from loam_tpu_torch.io import synth
from loam_tpu_torch.ops.features import extract_features
from loam_tpu_torch.state import (imu_stream_from_numpy,
                                  pipeline_state_from_numpy)

from golden.registration import scan_registration
from torch_parity import (make_sweeps, parity_cfg, pose_errors, to_port_cfg,
                          tree_to_numpy)

torch.set_num_threads(1)

DECODE_TOL = 2e-5
STEP_ROT, STEP_TRANS = 1e-5, 1e-4
REPLAY_ROT, REPLAY_TRANS = 1e-4, 1e-3
# the straight scenarios (seed, speed, yaw rate) whose whole 5-frame
# replays hold REPLAY_ROT / REPLAY_TRANS at 10 Hz (ROADMAP.md section 3)
STRAIGHT = ((3, 0.9, 0.12), (2, 0.9, 0.12), (6, 0.8, -0.12), (9, 0.6, 0.2),
            (10, 1.0, 0.1))
POSES = ("pose_odom", "pose_aft", "pose_integrated")


def _port_sweep(raw, msk, T):
    """The port's frontend at scan_period T, flattened to a PointCloud."""
    cfg = to_port_cfg(parity_cfg(scan_period=T))
    return TF.ingest_sweep(torch.tensor(raw), torch.tensor(msk),
                           cfg).flatten()


def _rel_time(raw, msk):
    """Each kept point's sweep fraction in ring-major order, in float64,
    from the golden oracle's intensity (ring + 0.1 * rel_time)."""
    full = scan_registration(raw, msk)["full"]
    return full.xyz, (full.intensity - np.trunc(full.intensity)) / 0.1


@pytest.mark.parametrize("T", [0.05, 0.1, 0.2])
def test_sweep_time_decodes_rel_time(T):
    """The frontend then sweep_time(scan_period) gives each point's
    rel_time at every rate; at 0.1 s it is bit-equal to loam_tpu's
    sweep_time()."""
    raw, msk, _ = make_sweeps(1, seed=3, scan_period=T)
    cloud = _port_sweep(raw[0], msk[0], T)
    xyz, want = _rel_time(raw[0], msk[0])
    np.testing.assert_array_equal(cloud.xyz[cloud.mask].numpy(), xyz)
    got = cloud.sweep_time(T)[cloud.mask].double().numpy()
    gap = float(np.abs(got - want).max())
    print(f"T={T}: largest decode gap {gap:.3g} (gate {DECODE_TOL})")
    assert gap < DECODE_TOL and want.max() > 0.99
    if T == 0.1:
        j = JF.ingest_sweep(jnp.asarray(raw[0]), jnp.asarray(msk[0]),
                            parity_cfg()).flatten()
        np.testing.assert_array_equal(cloud.sweep_time(0.1).numpy(),
                                      np.asarray(j.sweep_time()))


def test_loam_tpu_decode_is_fixed_at_ten_hz():
    """The fault left in loam_tpu: at scan_period 0.2 its sweep_time() is
    2 * rel_time, and its teacher-forced odometry step moves away from
    the reference semantics (loam_tpu at 0.1 s on the same sweeps); the
    port's decode is rel_time."""
    T = 0.2
    raw, msk, _ = make_sweeps(3, seed=5, scan_period=T)
    jcfg = parity_cfg(scan_period=T)
    j = JF.ingest_sweep(jnp.asarray(raw[2]), jnp.asarray(msk[2]),
                        jcfg).flatten()
    _, want = _rel_time(raw[2], msk[2])
    jt = np.asarray(j.sweep_time())[np.asarray(j.mask)].astype(np.float64)
    np.testing.assert_allclose(jt, 2.0 * want, rtol=0, atol=2 * DECODE_TOL)
    cloud = _port_sweep(raw[2], msk[2], T)
    np.testing.assert_allclose(cloud.sweep_time(T)[cloud.mask].double(),
                               want, rtol=0, atol=DECODE_TOL)

    ref_cfg = parity_cfg()
    _, st = JP.replay_sweeps(jnp.asarray(raw[:2]), jnp.asarray(msk[:2]),
                             ref_cfg, return_state=True)
    poses = []
    for cfg in (ref_cfg, jcfg):
        feats = j_extract(JF.ingest_sweep(jnp.asarray(raw[2]),
                                          jnp.asarray(msk[2]), cfg), cfg)
        poses.append(np.asarray(JO.odometry_step(st.odom, feats, None,
                                                 cfg)[1].pose))
    rot, trans = pose_errors(poses[1], poses[0])
    print(f"loam_tpu's step at {T} s against 0.1 s: {rot:.3g} rad, "
          f"{trans:.3g} m")
    assert rot > 10 * STEP_ROT or trans > 10 * STEP_TRANS


@pytest.mark.parametrize("T", [0.05, 0.2])
def test_odometry_step_at_rate_matches_reference(T):
    """One odometry step from loam_tpu's state after two frames, on
    sweeps made at T: the port at T against loam_tpu at 0.1 s (measured
    gap about 1e-9 rad / 3e-8 m)."""
    jcfg = parity_cfg()
    tcfg = to_port_cfg(parity_cfg(scan_period=T))
    raw, msk, _ = make_sweeps(3, seed=5, scan_period=T)
    _, st = JP.replay_sweeps(jnp.asarray(raw[:2]), jnp.asarray(msk[:2]), jcfg,
                             return_state=True)
    jfeats = j_extract(JF.ingest_sweep(jnp.asarray(raw[2]),
                                       jnp.asarray(msk[2]), jcfg), jcfg)
    _, jout = JO.odometry_step(st.odom, jfeats, None, jcfg)
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    tfeats = extract_features(TF.ingest_sweep(
        torch.tensor(raw[2]), torch.tensor(msk[2]), tcfg), tcfg)
    for name in ("sharp", "flat", "less_sharp"):
        a, b = getattr(jfeats, name), getattr(tfeats, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_array_equal(b.xyz.numpy(), np.asarray(a.xyz))
    _, tout = TO.odometry_step(tstate.odom, tfeats, tcfg)
    rot, trans = pose_errors(tout.pose.numpy(), jout.pose)
    print(f"T={T}: step gap {rot:.3g} rad, {trans:.3g} m")
    assert rot < STEP_ROT and trans < STEP_TRANS, (rot, trans)
    assert np.abs(np.asarray(jout.pose[3:])).max() > 0.05   # it moved
    for name in ("corner_last", "surf_last"):
        a, b = getattr(jout, name), getattr(tout, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_array_equal(b.rel.numpy(), np.asarray(a.rel))
        np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz),
                                   atol=1e-4)


@pytest.mark.parametrize("T", [0.05, 0.2])
@pytest.mark.parametrize("seed,speed,yaw_rate", STRAIGHT,
                         ids=[f"seed{s}" for s, _, _ in STRAIGHT])
def test_replay_at_rate_matches_reference(seed, speed, yaw_rate, T):
    """A whole 5-frame replay of sweeps made at T: the port at T against
    loam_tpu at 0.1 s, the cadence equal and each pose within 1e-4 rad /
    1e-3 m; at 0.2 s the odometry poses only (the module docstring)."""
    raw, msk, _ = make_sweeps(5, seed=seed, speed=speed, yaw_rate=yaw_rate,
                              scan_period=T)
    jouts = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), parity_cfg())
    touts = TP.replay_sweeps(raw, msk, to_port_cfg(parity_cfg(scan_period=T)),
                             device="cpu")
    np.testing.assert_array_equal(touts.mapped.numpy(),
                                  np.asarray(jouts.mapped))
    assert touts.mapped.numpy().sum() == 2
    gaps = {n: pose_errors(getattr(touts, n).numpy(), getattr(jouts, n))
            for n in POSES}
    print(f"T={T}, seed {seed}: gaps {gaps}")
    for name in POSES if T < 0.1 else ("pose_odom",):
        rot, trans = gaps[name]
        assert rot < REPLAY_ROT and trans < REPLAY_TRANS, (name, rot, trans)
    assert np.isfinite(touts.pose_integrated.numpy()).all()
    if T > 0.1:
        # the control: the port at 0.1 s, which encodes and decodes as
        # loam_tpu does, on the same sweeps
        ctrl = TP.replay_sweeps(raw, msk, to_port_cfg(parity_cfg()),
                                device="cpu")
        print(f"T={T}, seed {seed}: the port at 0.1 s against loam_tpu "
              f"{pose_errors(ctrl.pose_aft.numpy(), jouts.pose_aft)}")


def test_imu_functions_at_five_hz_match():
    """integrate, sweep_state, deskew_points, imu_trans and rpy_at at
    scan_period 0.2 s against loam_tpu's at 0.2 s, within
    tests/test_torch_imu.py's tolerances, on the oscillating trajectory's
    windows and on a window with a 0.15 s gap (integrated at 0.2 s, a
    dropout at 0.1 s)."""
    T = 0.2
    jcfg = parity_cfg(scan_period=T)
    tcfg = to_port_cfg(jcfg)
    pose_fn = synth.oscillating_trajectory()
    t_scans = (0.06 + T * np.arange(3)).astype(np.float32)
    ws = [synth.simulate_imu_window(pose_fn, t0=float(t), scan_period=T)
          for t in t_scans]
    tree = {n: np.stack([w[i] for w in ws])
            for i, n in enumerate(("t", "rpy", "acc", "mask"))}
    # frame 2: samples 10 ms apart with a 0.15 s gap after the fifth
    tree["t"][2] = np.where(np.arange(64) < 5, 0.0, 0.14) + tree["t"][2, 0] \
        + 0.01 * np.arange(64)
    tree["mask"][2] = np.arange(64) < 20
    assert int(tree["mask"][0].sum()) > 50
    rng = np.random.default_rng(2)
    rel = np.sort(rng.uniform(0, 1, (3, 4, 40)), -1).astype(np.float32)
    pmask = rng.uniform(size=rel.shape) < 0.8
    xyz = rng.uniform(-30, 30, rel.shape + (3,)).astype(np.float32)

    ts = imu_stream_from_numpy(tree, device="cpu")
    tinteg = TI.integrate(ts, tcfg)
    tsw = TI.sweep_state(ts, tinteg, torch.tensor(t_scans), torch.tensor(rel),
                         torch.tensor(pmask), tcfg)
    tdesk = TI.deskew_points(torch.tensor(xyz), tsw)
    ttrans = TI.imu_trans(tsw)
    trpy, tok = TI.rpy_at(ts, torch.tensor(t_scans + np.float32(T)))

    def close(port, jax_obj, **tol):
        jt = tree_to_numpy(jax_obj)
        for name, val in tree_to_numpy(port).items():
            if val.dtype == bool:
                np.testing.assert_array_equal(val, jt[name], err_msg=name)
            else:
                np.testing.assert_allclose(val, jt[name], err_msg=name, **tol)

    for k in range(3):
        js = JI.ImuStream(**{n: jnp.asarray(v[k]) for n, v in tree.items()})
        jinteg = JI.integrate(js, jcfg)
        close(TI.ImuIntegral(tinteg.velo[k], tinteg.shift[k]), jinteg,
              rtol=1e-5, atol=1e-7)
        jsw = JI.sweep_state(js, jinteg, jnp.float32(t_scans[k]),
                             jnp.asarray(rel[k]), jnp.asarray(pmask[k]), jcfg)
        close(dataclasses.replace(tsw, **{
            f.name: getattr(tsw, f.name)[k]
            for f in dataclasses.fields(tsw)}), jsw, atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            tdesk[k].numpy(),
            np.asarray(JI.deskew_points(jnp.asarray(xyz[k]), jsw)), atol=1e-5)
        close(ttrans.map(lambda x: x[k]), JI.imu_trans(jsw), atol=1e-6,
              rtol=0)
        jrpy, jok = JI.rpy_at(js, jnp.float32(t_scans[k] + np.float32(T)))
        np.testing.assert_allclose(trpy[k].numpy(), np.asarray(jrpy),
                                   atol=1e-6)
        assert bool(tok[k]) == bool(jok)
    # the gap is integrated at 0.2 s and a dropout at 0.1 s
    v = tinteg.velo[2].numpy()
    v10 = TI.integrate(ts, dataclasses.replace(tcfg, scan_period=0.1)
                       ).velo[2].numpy()
    assert not np.array_equal(v[5], v[4]) and np.array_equal(v10[5], v10[4])
