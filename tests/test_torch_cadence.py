"""The mapping cadence at skip_frame_num != 1: loam_tpu_torch against
loam_tpu (CPU, plain kernel versions).

Mapping runs at frame 1 (the first solved frame), then every
(skip_frame_num + 1)-th: the C++ starts its odometry counter at
skipFrameNum (src/laserOdometry.cpp:51,886), and so do the port's
OdomState.create and both packages' mapping_frame.  loam_tpu's counter
starts at a fixed 1 (loam_tpu/odometry.py:46), the same cadence only at
skip_frame_num <= 1: at 2 its replay_sweeps maps frames 2, 5, ... while
its mapping_frame and its static core (replay_features_cadenced) map 1,
4, ..., and the static core reports the counter's frames as `mapped`.
The port follows the C++ everywhere; test_loam_tpu_counter_starts_at_one
records loam_tpu's disagreement with itself.

So the port is held to loam_tpu's static core on loam_tpu's features:
odometry poses within 1e-6 rad / 1e-5 m (the odometry does not depend
on the cadence) and the whole replay within
tests/test_torch_pipeline.py's 1e-4 rad / 1e-3 m; the first solving
mapping frame, teacher-forced from loam_tpu's state, is held in
tests/test_torch_cadence_step.py (loam_tpu run op by op costs a file
of its own).  F = 1 + 2 * (skip +
1) sweeps give two mapping frames, the second the first solve, as the
5-frame replays at skip 1.  The scenario is test_torch_pipeline.py's
(make_sweeps seed 3, 0.9 m/s, 0.12 rad/s), the first of ROADMAP.md
section 3's straight scenarios that hold that bound at skip 1, taken
before any run at another skip; make_sweeps is prefix-consistent
(sweep k depends on poses k and k + 1 and seed + k only), so every
skip slices one set of 9 sweeps.  At skip 2 every other entry point
that carries the cadence equals the replay bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, odometry as JO
from loam_tpu import pipeline as JP
from loam_tpu.ops.features import extract_features as j_extract

from loam_tpu_torch import checkpoint as CK, cli as TC, entry as E
from loam_tpu_torch import frontend as TF, odometry as TO
from loam_tpu_torch import pipeline as TP
from loam_tpu_torch.io import export
from loam_tpu_torch.ops.features import extract_features
from loam_tpu_torch.parallel import replay as TR
from loam_tpu_torch.runtime.streaming import StreamingEngine
from loam_tpu_torch.types import tree_map

from torch_parity import (feats_to_torch, make_sweeps,
                          masked_imu_windows, online_rule_replay,
                          paced_engine_run, parity_cfg, pose_errors,
                          to_port_cfg, tree_to_numpy)

torch.set_num_threads(1)

SKIPS = (0, 2, 3)
SEED = 3
ODOM_ROT, ODOM_TRANS = 1e-6, 1e-5
REPLAY_ROT, REPLAY_TRANS = 1e-4, 1e-3
POSES = ("pose_odom", "pose_aft", "pose_integrated")
MAX_F = 1 + 2 * (max(SKIPS) + 1)


def _frames(skip: int) -> int:
    return 1 + 2 * (skip + 1)


def _cadence(skip: int, frames: int):
    return np.array([TP.mapping_frame(k, to_port_cfg(parity_cfg(
        skip_frame_num=skip))) for k in range(frames)])


@pytest.fixture(scope="module")
def sweeps():
    """MAX_F sweeps of the scenario and loam_tpu's features of each."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(MAX_F, seed=SEED)
    js = jax.vmap(lambda x, m: JF.ingest_sweep(x, m, cfg))(
        jnp.asarray(raw), jnp.asarray(msk))
    jf = jax.vmap(lambda s: j_extract(s, cfg))(js)
    return raw, msk, jf


@pytest.fixture(scope="module")
def static_cores(sweeps):
    """skip -> loam_tpu's replay_features_cadenced of the first
    _frames(skip) frames' features, made on first use."""
    _, _, jf = sweeps
    made = {}

    def get(skip):
        if skip not in made:
            F = _frames(skip)
            made[skip] = JP.replay_features_cadenced(
                jax.tree_util.tree_map(lambda x: x[:F], jf),
                parity_cfg(skip_frame_num=skip))
        return made[skip]

    return get


def test_loam_tpu_counter_starts_at_one(sweeps, static_cores):
    """The fault left in loam_tpu at skip_frame_num = 2: its odometry
    counter starts at 1, so replay_sweeps maps frames 2 and 5, while its
    mapping_frame (the C++'s cadence) gives 1 and 4, which its static
    core follows: the core's first solve is frame 4 (a map from frame
    1), yet it reports the counter's frames 2 and 5 as `mapped`."""
    skip = 2
    cfg = parity_cfg(skip_frame_num=skip)
    F = _frames(skip)
    raw, msk = (a[:F] for a in sweeps[:2])
    dynamic = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg)
    np.testing.assert_array_equal(np.asarray(dynamic.mapped),
                                  [0, 0, 1, 0, 0, 1, 0])
    assert [JP.mapping_frame(k, cfg) for k in range(F)] == \
        [0, 1, 0, 0, 1, 0, 0]
    assert int(JO.OdomState.create(cfg).frame_count) == 1
    outs, _ = static_cores(skip)
    np.testing.assert_array_equal(np.asarray(outs.mapped),
                                  [0, 0, 1, 0, 0, 1, 0])
    aft = np.asarray(outs.pose_aft)
    assert not aft[:4].any() and np.abs(aft[4, 3:]).max() > 0.1
    # the port's counter starts at skip_frame_num, and its flags are
    # mapping_frame's
    port = to_port_cfg(cfg)
    assert int(TO.OdomState.create(port, "cpu").frame_count) == skip
    touts = TP.replay_sweeps(raw, msk, port, device="cpu")
    np.testing.assert_array_equal(touts.mapped.numpy(), _cadence(skip, F))


@pytest.mark.parametrize("skip", SKIPS)
def test_replay_maps_on_mapping_frame(skip, sweeps):
    """The port's replay_sweeps maps where mapping_frame says, at each
    skip: frame 1 and frame 1 + (skip + 1)."""
    raw, msk, _ = sweeps
    F = _frames(skip)
    outs = TP.replay_sweeps(raw[:F], msk[:F],
                            to_port_cfg(parity_cfg(skip_frame_num=skip)),
                            device="cpu")
    mapped = outs.mapped.numpy()
    np.testing.assert_array_equal(mapped, _cadence(skip, F))
    assert np.flatnonzero(mapped).tolist() == [1, skip + 2]
    assert np.isfinite(outs.pose_integrated.numpy()).all()


@pytest.mark.parametrize("skip", SKIPS)
def test_static_core_matches_loam_tpu(skip, sweeps, static_cores):
    """The port's replay_features_cadenced of loam_tpu's features against
    loam_tpu's: mapping where loam_tpu's mapping_frame says, odometry
    poses within 1e-6 rad / 1e-5 m, the whole replay within 1e-4 rad /
    1e-3 m, and the first solve moved the mapped pose."""
    _, _, jf = sweeps
    F = _frames(skip)
    cfg = parity_cfg(skip_frame_num=skip)
    jouts, _ = static_cores(skip)
    touts, _ = TP.replay_features_cadenced(
        feats_to_torch(jax.tree_util.tree_map(lambda x: x[:F], jf)),
        to_port_cfg(cfg), device="cpu")
    np.testing.assert_array_equal(
        touts.mapped.numpy(), [JP.mapping_frame(k, cfg) for k in range(F)])
    rot, trans = pose_errors(touts.pose_odom.numpy(), jouts.pose_odom)
    assert rot < ODOM_ROT and trans < ODOM_TRANS, (rot, trans)
    for name in POSES:
        rot, trans = pose_errors(getattr(touts, name).numpy(),
                                 getattr(jouts, name))
        assert rot < REPLAY_ROT and trans < REPLAY_TRANS, (name, rot, trans)
    solve = skip + 2
    assert np.abs(touts.pose_aft.numpy()[solve, 3:]).max() > 0.1


# ---- every entry point that carries the cadence, at skip 2

SKIP = 2


@pytest.fixture(scope="module")
def skip2(sweeps):
    """The port's replay_sweeps of the first _frames(SKIP) sweeps at
    SKIP, with its final state."""
    raw, msk, _ = sweeps
    F = _frames(SKIP)
    cfg = to_port_cfg(parity_cfg(skip_frame_num=SKIP))
    outs, state = TP.replay_sweeps(raw[:F], msk[:F], cfg, return_state=True,
                                   device="cpu")
    np.testing.assert_array_equal(outs.mapped.numpy(), _cadence(SKIP, F))
    return cfg, raw[:F], msk[:F], outs, state


def _assert_same_frames(got, want):
    for name in POSES + ("mapped",):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_static_cadence_equals_replay(skip2):
    """replay_features_cadenced of the port's own features equals
    replay_sweeps (the publish flags' cadence) bit for bit."""
    cfg, raw, msk, outs, state = skip2
    feats = extract_features(TF.ingest_sweep(torch.tensor(raw),
                                             torch.tensor(msk), cfg), cfg)
    couts, cstate = TP.replay_features_cadenced(feats, cfg, device="cpu")
    _assert_same_frames(couts, outs)
    for a, b in zip(*(tree_to_numpy(s.map.surf_map).values()
                      for s in (cstate, state))):
        np.testing.assert_array_equal(a, b)
    assert int(cstate.odom.frame_count) == int(state.odom.frame_count)


def test_batched_replay_equals_singles(skip2):
    """batched_replay of two scenarios (the scenario and seed 2, another
    straight scenario of ROADMAP.md section 3) equals its two single
    replays bit for bit: the lockstep batch shares the cadence."""
    cfg, raw, msk, outs, _ = skip2
    raw2, msk2, _ = make_sweeps(raw.shape[0], seed=2)
    batch = TR.batched_replay(np.stack([raw, raw2]), np.stack([msk, msk2]),
                              cfg, device="cpu")
    second = TP.replay_sweeps(raw2, msk2, cfg, device="cpu")
    for b, single in enumerate((outs, second)):
        _assert_same_frames(tree_map(lambda t: t[b], batch), single)
    assert not torch.equal(second.pose_odom, outs.pose_odom)


def test_streaming_engine_equals_replay(skip2):
    """The engine paced one sweep at a time maps on the cadence and
    equals the replay bit for bit by the integration rule (the engine
    always integrates IMU windows; with no sample pushed they are all
    masked)."""
    cfg, raw, msk, outs, _ = skip2
    F = raw.shape[0]
    t_scans = 0.06 + 0.1 * np.arange(F)
    eng = StreamingEngine(cfg, device="cpu")
    eng.start()
    try:
        odom, aft, integrated = paced_engine_run(eng, raw, msk, t_scans)
        st = eng.stats()
    finally:
        eng.stop()
    ref, online = online_rule_replay(
        raw, msk, cfg, "cpu", masked_imu_windows(F),
        torch.tensor(t_scans.astype(np.float32)))
    np.testing.assert_array_equal(ref.mapped.numpy(), _cadence(SKIP, F))
    np.testing.assert_array_equal(odom, ref.pose_odom.numpy())
    np.testing.assert_array_equal(aft, ref.pose_aft.numpy())
    np.testing.assert_array_equal(integrated, online.numpy())
    assert st.map_frames == 2 and st.odom_frames == F
    _assert_same_frames(ref, outs)


def test_cli_streaming_clouds_follow_the_cadence(skip2, tmp_path,
                                                 monkeypatch):
    """The command line's chunked replay (chunks of map_frame_num *
    (skip_frame_num + 1) = 3 sweeps at map_frame_num 1) writes the
    replay's trajectories, a registered cloud on each mapping frame (1
    and 4) and a surround cloud at each chunk's end (2, 5, 6); the
    replay's registered cloud is empty on every other frame."""
    cfg, _, _, _, _ = skip2
    cfg = dataclasses.replace(cfg, map_frame_num=1)
    monkeypatch.setattr(TC, "_config", lambda args: cfg)
    F = _frames(SKIP)
    out = tmp_path / "out"
    argv = ["--synthetic", str(F), "--ring-width", "512"]
    assert TC.main(argv + ["--device", "cpu", "--out-dir", str(out),
                           "--stream-clouds"]) == 0
    assert sorted(os.listdir(out / "clouds")) == [
        "registered_0001.ply", "registered_0004.ply", "surround_0002.ply",
        "surround_0005.ply", "surround_0006.ply"]
    args = TC.build_parser().parse_args(argv)
    raw, msk, stamps, _ = TC._load_data(args, cfg)
    outs = TP.replay_sweeps(raw, msk, dataclasses.replace(
        cfg, emit_registered=True), device="cpu")
    np.testing.assert_array_equal(outs.mapped.numpy(), _cadence(SKIP, F))
    reg = outs.registered
    np.testing.assert_array_equal(reg.mask.any(-1).numpy(),
                                  outs.mapped.numpy())
    for k in (1, 4):
        got = export.load_cloud_ply(str(out / "clouds"
                                        / f"registered_{k:04d}.ply"))
        np.testing.assert_array_equal(got, reg.xyz[k][reg.mask[k]].numpy())
    for name, field in (("odom", "pose_odom"), ("aft_mapped", "pose_aft"),
                        ("integrated", "pose_integrated")):
        want = tmp_path / f"{name}.tum"
        export.save_trajectory_tum(str(want), stamps,
                                   getattr(outs, field).numpy())
        assert (out / f"{name}.tum").read_bytes() == want.read_bytes(), name


def test_checkpoint_resumes_mid_period(skip2, tmp_path):
    """A checkpointed replay interrupted after frame 2, between the
    mapping frames 1 and 4 (the counter at 1 of 3), resumes from the
    checkpoint exactly: every frame and the final state bit for bit."""
    cfg, raw, msk, outs, state = skip2
    feats = extract_features(TF.ingest_sweep(torch.tensor(raw),
                                             torch.tensor(msk), cfg), cfg)

    def step(s, frame):
        return TP.pipeline_step(s, frame, cfg)

    ck = CK.CheckpointManager(str(tmp_path / "ck"))
    _, first = CK.checkpointed_replay(
        step, TP.PipelineState.create(cfg, "cpu"), feats.map(lambda t: t[:3]),
        ck, every=3)
    assert ck.steps() == [3]
    saved, meta = ck.restore(3, TP.PipelineState.create(cfg, "cpu"))
    assert meta == {"next_frame": 3} and int(saved.odom.frame_count) == 1
    resumed, rest = CK.checkpointed_replay(
        step, TP.PipelineState.create(cfg, "cpu"), feats, ck, every=0)
    assert len(first) == 3 and len(rest) == raw.shape[0] - 3
    _assert_same_frames(tree_map(lambda *ts: torch.stack(ts),
                                 *(first + rest)), outs)
    got, want = [], []
    tree_map(got.append, resumed)
    tree_map(want.append, state)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_entry_forward_stepped_equals_replay(skip2):
    """The one-frame forward (mapping on the publish flags), stepped over
    the sweeps, equals the replay's integrated poses bit for bit and
    leaves the counter where the replay does."""
    cfg, raw, msk, outs, state = skip2
    fn, (_, _, st) = E.entry(device="cpu", cfg=cfg)
    poses = []
    for k in range(raw.shape[0]):
        st, pose = fn(torch.tensor(raw[k]), torch.tensor(msk[k]), st)
        poses.append(pose)
    assert torch.equal(torch.stack(poses), outs.pose_integrated)
    assert torch.equal(st.odom.frame_count, state.odom.frame_count)
    assert torch.equal(st.map.transform_aft, state.map.transform_aft)
