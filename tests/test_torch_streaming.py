"""loam_tpu_torch.runtime.streaming against loam_tpu's streaming engine
and the port's own replay (CPU, plain kernel versions).

A paced run (drain() after every push) must equal replay_sweeps bit for
bit by the engine's integration rule: odometry and aft-mapped poses as
the replay's, and the integrated pose composed from the bef/aft pair of
the last mapping frame that finished before the frame
(torch_parity.online_rule_replay).  The engine always runs the IMU
frontend, so without push_imu it equals the replay given the same
all-masked windows.
"""

import dataclasses
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu.runtime import streaming as JS

from loam_tpu_torch import imu as TI, pipeline as TP
from loam_tpu_torch.io import rosbag as TRBAG, synth
from loam_tpu_torch.ops.cuda import _build
from loam_tpu_torch.runtime.streaming import NativeQueue, StreamingEngine
from loam_tpu_torch.types import tree_map

from torch_parity import (imu_samples, make_sweeps, masked_imu_windows,
                          online_rule_replay, paced_engine_run, parity_cfg,
                          raw_imu, to_port_cfg, tree_to_numpy)

torch.set_num_threads(1)

FRAMES = 6
T0 = 0.06


def test_native_queue_drop_oldest():
    q = NativeQueue(2)
    assert q.push("a")
    assert q.push("b")
    assert not q.push("c")  # drops "a"
    assert q.pop(0) == "b"
    assert q.pop(0) == "c"
    assert q.pop(10) is None  # timeout
    st = q.stats()
    assert st["pushed"] == 3 and st["dropped"] == 1 and st["popped"] == 2
    q.close()
    assert q.pop(0) is None


def test_native_queue_threaded():
    q = NativeQueue(64)
    got = []

    def consumer():
        while True:
            item = q.pop(2000)
            if item is None:
                return
            got.append(item)
            if len(got) == 50:
                return

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(50):
        q.push(i)
    t.join(timeout=10)
    assert sorted(got) == list(range(50))
    q.close()


@pytest.mark.parametrize("builder", ["native", "kernels"])
def test_builders_are_thread_safe(builder, tmp_path, monkeypatch):
    """Four threads load the native library (g++), or a kernel's entry
    point (nvcc), from a fresh build directory at once: one library,
    one loaded object, no temporary file left behind."""
    if builder == "native":
        monkeypatch.setattr(TRBAG, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(TRBAG, "_lib", None)
        load = TRBAG._load
    else:
        if shutil.which("nvcc") is None and not os.path.exists(
                "/usr/local/cuda/bin/nvcc"):
            pytest.skip("needs nvcc to build a kernel")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "_ENTRIES", {})
        load = lambda: _build.entry("kselect", ())   # noqa: E731
    barrier = threading.Barrier(4)
    got, errors = [], []

    def worker():
        try:
            barrier.wait()
            got.append(load())
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert len(got) == 4 and all(g is got[0] for g in got)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 1 and names[0].endswith(".so"), names


@pytest.fixture(scope="module")
def sweeps():
    raw, msk, _ = make_sweeps(FRAMES)
    return to_port_cfg(parity_cfg()), raw, msk, T0 + 0.1 * np.arange(FRAMES)


def _hold_to_replay(paced, ref, online):
    """The engine's paced run against the replay by the integration
    rule, bit for bit."""
    odom, aft, integrated = paced
    np.testing.assert_array_equal(odom, ref.pose_odom.numpy())
    np.testing.assert_array_equal(aft, ref.pose_aft.numpy())
    np.testing.assert_array_equal(integrated, online.numpy())
    mapped = ref.mapped.numpy()
    # the rule differs from the replay's integration only where a
    # mapping frame solved
    np.testing.assert_array_equal(integrated[~mapped],
                                  ref.pose_integrated.numpy()[~mapped])
    return mapped


def test_paced_engine_equals_replay(sweeps):
    """Six paced frames without IMU samples equal replay_sweeps given
    all-masked windows, bit for bit, by the integration rule.  Measured:
    on these sweeps that replay also equals replay_sweeps with
    imu_streams=None bit for bit (gap 0 rad / 0 m): a window without
    samples adds exact zeros to the priors and no deskew."""
    cfg, raw, msk, t_scans = sweeps
    eng = StreamingEngine(cfg, device="cpu")
    eng.start()
    try:
        paced = paced_engine_run(eng, raw, msk, t_scans)
        st = eng.stats()
    finally:
        eng.stop()
    t_t = torch.tensor(t_scans.astype(np.float32))
    windows = masked_imu_windows(FRAMES)
    ref, online = online_rule_replay(raw, msk, cfg, "cpu", windows, t_t)
    whole = TP.replay_sweeps(raw, msk, cfg, windows, t_t, device="cpu")
    for name in ("pose_odom", "pose_aft", "pose_integrated", "mapped"):
        assert torch.equal(getattr(ref, name), getattr(whole, name)), name
    mapped = _hold_to_replay(paced, ref, online)
    assert mapped.sum() == 3 and st.map_frames == 3
    assert st.frames_in == st.odom_frames == st.integrated == FRAMES
    assert all(q["dropped"] == 0 for q in st.queue_stats.values())
    plain = TP.replay_sweeps(raw, msk, cfg, device="cpu")
    gap = (plain.pose_integrated - whole.pose_integrated).abs().max()
    assert float(gap) == 0.0


def test_paced_engine_with_imu_equals_replay():
    """The same paced run along the oscillating trajectory with its
    200 Hz IMU pushed ahead of each sweep (raw sensor_msgs/Imu content,
    torch_parity.raw_imu) equals replay_sweeps given the engine's own
    windows of those samples, bit for bit; the IMU moves the poses."""
    cfg = to_port_cfg(parity_cfg())
    world = synth.make_world(seed=11)
    pose_fn = synth.oscillating_trajectory()
    t_scans = T0 + 0.1 * np.arange(FRAMES)
    sw = [synth.simulate_sweep_traj(world, pose_fn, t0=float(t),
                                    n_azimuth=480, seed=11 + k)
          for k, t in enumerate(t_scans)]
    raw = np.stack([s[0] for s in sw])
    msk = np.stack([s[1] for s in sw])
    imu_t, pyr, acc = imu_samples(pose_fn, float(t_scans[-1]) + 0.25)
    rpy, acc_velodyne = raw_imu(pyr, acc)
    eng = StreamingEngine(cfg, device="cpu")
    eng.start()
    try:
        paced = paced_engine_run(eng, raw, msk, t_scans,
                                 (imu_t, rpy, acc_velodyne))
        windows = [eng._imu_window(float(t)) for t in t_scans]
    finally:
        eng.stop()
    streams = TI.imu_from_raw(*(torch.tensor(np.stack([w[i] for w in
                                                       windows]))
                                for i in range(4)))
    assert bool(streams.mask.sum(-1).min() >= 2)
    t_t = torch.tensor(t_scans.astype(np.float32))
    ref, online = online_rule_replay(raw, msk, cfg, "cpu", streams, t_t)
    whole = TP.replay_sweeps(raw, msk, cfg, streams, t_t, device="cpu")
    for name in ("pose_odom", "pose_aft", "pose_integrated", "mapped"):
        assert torch.equal(getattr(ref, name), getattr(whole, name)), name
    _hold_to_replay(paced, ref, online)
    plain = TP.replay_sweeps(raw, msk, cfg, device="cpu")
    assert float((plain.pose_odom - whole.pose_odom).abs().max()) > 1e-4


def _samples():
    rng = np.random.default_rng(4)
    t = np.cumsum(rng.uniform(0.003, 0.007, 400))
    return t, rng.normal(0, 0.3, (400, 3)), rng.normal(0, 2.0, (400, 3))


def test_imu_window_matches_loam_tpu():
    """After the same push_imu calls the port's per-sweep window equals
    the JAX engine's, including a window past the 2048-sample buffer's
    start and one with no sample (constructing the JAX engine compiles
    nothing: its stages are jitted lazily)."""
    cfg = parity_cfg()
    jeng = JS.StreamingEngine(cfg)
    teng = StreamingEngine(to_port_cfg(cfg), device="cpu")
    t, rpy, acc = _samples()
    for i in range(t.shape[0]):
        jeng.push_imu(t[i], rpy[i], acc[i])
        teng.push_imu(t[i], rpy[i], acc[i])
    for t_scan in (0.0, 0.35, float(t[200]), float(t[-1]) - 0.05, 10.0):
        for a, b in zip(jeng._imu_window(t_scan), teng._imu_window(t_scan)):
            np.testing.assert_array_equal(a, b)


def test_frontend_stage_matches_loam_tpu():
    """The engine's frontend stage on one oscillating sweep with its IMU
    window against the JAX engine's _front run op by op
    (jax.disable_jit), within the tolerances of test_torch_imu's ingest
    and deskewed-feature tests: masks identical, points within 1e-5 m,
    the less-flat voxel means' rel within 1e-5, ImuTrans and the mapping
    blend's [pitch, roll, ok] within 1e-6.  The other rel values are
    within one ulp, not identical: op by op, JAX rounds ring +
    scanPeriod * relTime twice, where jitted XLA:CPU (and the port,
    numerics.fma) contracts it into one fused multiply-add."""
    cfg = parity_cfg()
    world = synth.make_world(seed=11)
    pose_fn = synth.oscillating_trajectory()
    t_scan = T0 + 0.3
    xyz, m = synth.simulate_sweep_traj(world, pose_fn, t0=t_scan,
                                       n_azimuth=480, seed=14)
    imu_t, pyr, acc = imu_samples(pose_fn, t_scan + 0.25)
    rpy, acc_velodyne = raw_imu(pyr, acc)
    teng = StreamingEngine(to_port_cfg(cfg), device="cpu")
    for i in range(imu_t.shape[0]):
        teng.push_imu(imu_t[i], rpy[i], acc_velodyne[i])
    win = teng._imu_window(t_scan)
    assert win[3].sum() >= 2
    jeng = JS.StreamingEngine(cfg)
    with jax.disable_jit():
        jfeats, jtrans, jrpy = jeng._front(
            jnp.asarray(xyz), jnp.asarray(m),
            *(jnp.asarray(a) for a in win), jnp.asarray(np.float32(t_scan)))
    tfeats, ttrans, trpy = teng._front(
        torch.tensor(xyz, dtype=torch.float32), torch.tensor(m),
        *(torch.from_numpy(a) for a in win),
        torch.tensor(np.float32(t_scan)))
    np.testing.assert_allclose(trpy.numpy(), np.asarray(jrpy), atol=1e-6)
    jt, tt = tree_to_numpy(jtrans), tree_to_numpy(ttrans)
    for name in jt:
        np.testing.assert_allclose(tt[name], jt[name], atol=1e-6,
                                   err_msg=name)
    for f in dataclasses.fields(tfeats):
        a, b = getattr(jfeats, f.name), getattr(tfeats, f.name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        want = np.asarray(a.rel)
        rel_tol = 1e-5 if f.name == "less_flat" else np.spacing(np.abs(want))
        assert (np.abs(b.rel.numpy() - want) <= rel_tol).all(), f.name
        np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz),
                                   atol=1e-5, rtol=0, err_msg=f.name)
    assert int(tfeats.sharp.count()) > 0 and int(tfeats.flat.count()) > 0


def test_stage_failure_reaches_the_caller(sweeps, monkeypatch):
    """An exception in a stage thread stops the engine and is raised by
    drain(), by stop() and by the next push: no stage dies silently."""
    cfg, raw, msk, t_scans = sweeps
    eng = StreamingEngine(cfg, device="cpu")

    def broken(*args, **kw):
        raise FloatingPointError("odometry stage broke")

    monkeypatch.setattr(eng, "_process_odom", broken)
    eng.start()
    eng.push_sweep(raw[0], msk[0], float(t_scans[0]))
    with pytest.raises(FloatingPointError, match="odometry stage broke"):
        eng.drain(timeout_s=60)
    with pytest.raises(FloatingPointError):
        eng.push_sweep(raw[1], msk[1], float(t_scans[1]))
    with pytest.raises(FloatingPointError):
        eng.push_imu(0.0, np.zeros(3), np.zeros(3))
    with pytest.raises(FloatingPointError):
        eng.stop()
    assert eng.stats().odom_frames == 0


def test_drain_waits_for_a_sweep_between_stages(sweeps, monkeypatch):
    """drain() returns only once the pushed sweep's odometry frame is
    done, also while a stage holds a sweep it has popped and not yet
    processed (the window in which queue depths and busy flags, which
    the JAX engine's drain polls, read idle)."""
    cfg, raw, msk, t_scans = sweeps
    eng = StreamingEngine(cfg, device="cpu")
    pop = eng.q_feats.pop

    def slow_pop(timeout_ms=-1):
        item = pop(timeout_ms)
        if item is not None:
            time.sleep(0.2)
        return item

    monkeypatch.setattr(eng.q_feats, "pop", slow_pop)
    eng.start()
    try:
        for k in range(2):
            eng.push_sweep(raw[k], msk[k], float(t_scans[k]))
            assert eng.drain(timeout_s=120)
            assert eng.stats().odom_frames == k + 1
    finally:
        eng.stop()


def test_flood_sheds_load(sweeps):
    """Thirty sweeps pushed with no pacing after a warm one: the oldest
    are dropped, not stalled on, and every sweep is accounted for (the
    JAX package's test_streaming_engine_sheds_load)."""
    cfg, raw, msk, _ = sweeps
    eng = StreamingEngine(cfg, device="cpu")
    eng.start()
    try:
        eng.push_sweep(raw[0], msk[0])
        assert eng.drain(timeout_s=120)
        for k in range(30):
            eng.push_sweep(raw[k % FRAMES], msk[k % FRAMES])
        assert eng.drain(timeout_s=300)
        st = eng.stats()
        traj = eng.trajectory()
    finally:
        eng.stop()
    q = st.queue_stats
    assert st.frames_in == 31
    assert q["raw"]["dropped"] > 0
    assert st.odom_frames + q["raw"]["dropped"] + q["feats"]["dropped"] == 31
    assert traj.shape == (st.odom_frames, 6) and np.isfinite(traj).all()


def test_engine_device_defaults_to_the_card():
    """device=None is the CUDA device: without one the engine raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        StreamingEngine(to_port_cfg(parity_cfg()))


def test_engine_state_tree_is_the_replays(sweeps):
    """After a paced run the engine's map state equals the replay's
    final map state, leaf for leaf (the voxel tables, bef/aft)."""
    cfg, raw, msk, t_scans = sweeps
    eng = StreamingEngine(cfg, device="cpu")
    eng.start()
    try:
        paced_engine_run(eng, raw, msk, t_scans)
        state, aft = eng.map_state_snapshot()
    finally:
        eng.stop()
    t_t = torch.tensor(t_scans.astype(np.float32))
    _, final = TP.replay_sweeps(raw, msk, cfg, masked_imu_windows(FRAMES),
                                t_t, return_state=True, device="cpu")
    a, b = [], []
    tree_map(a.append, state)
    tree_map(b.append, final.map)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    np.testing.assert_array_equal(aft, final.map.transform_aft.numpy())
