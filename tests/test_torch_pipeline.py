"""loam_tpu_torch's default replay path, end to end, against loam_tpu
(CPU, plain kernel versions).

replay_sweeps runs five frames (two mapping frames) through both
packages from the same seeded NumPy sweeps.  The mapping cadence is an
integer decision and must be identical.  Per-frame poses are held to
1e-3 m / 1e-4 rad: the port reproduces the JAX iterations op by op
(tests/test_torch_mapping.py holds one mapping frame to 1e-5 m), but the
jitted JAX replay fuses each Gauss-Newton body, which rounds differently
by ~1e-4 m per mapping solve, and the recurrence carries that forward.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import metrics as JMet, pipeline as JP

from loam_tpu_torch import metrics as TMet, pipeline as TP
from loam_tpu_torch import frontend as TF
from loam_tpu_torch.ops.features import extract_features

from torch_parity import make_sweeps, parity_cfg, pose_errors, to_port_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 5


@pytest.fixture(scope="module")
def replays():
    cfg = parity_cfg()
    raw, msk, poses = make_sweeps(FRAMES, seed=3)
    jouts = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg)
    # NumPy in, as a user would hand them over; the CPU only on request
    touts, tstate = TP.replay_sweeps(raw, msk, to_port_cfg(cfg),
                                     return_state=True, device="cpu")
    return cfg, raw, msk, poses, jouts, touts, tstate


def test_replay_sweeps_matches_loam_tpu(replays):
    _, _, _, _, jouts, touts, _ = replays
    np.testing.assert_array_equal(touts.mapped.numpy(),
                                  np.asarray(jouts.mapped))
    assert touts.mapped.numpy().sum() == 2
    for name in ("pose_odom", "pose_aft", "pose_integrated"):
        rot, trans = pose_errors(getattr(touts, name).numpy(),
                                 getattr(jouts, name))
        assert rot < 1e-4 and trans < 1e-3, (name, rot, trans)
    est = touts.pose_integrated.numpy()
    assert np.isfinite(est).all()
    # the sensor moves 0.09 m a frame
    assert np.abs(est[-1, 3:6]).max() > 0.2


def test_replay_features_cadenced_matches_replay(replays):
    """The static-cadence replay of the same features reproduces the
    publish-flag replay exactly (same ops in the same order)."""
    cfg, raw, msk, _, _, touts, tstate = replays
    cfg = to_port_cfg(cfg)
    feats = extract_features(TF.ingest_sweep(torch.tensor(raw),
                                             torch.tensor(msk), cfg), cfg)
    couts, cstate = TP.replay_features_cadenced(feats, cfg, device="cpu")
    for name in ("pose_odom", "pose_aft", "pose_integrated", "mapped"):
        assert torch.equal(getattr(couts, name), getattr(touts, name)), name
    assert torch.equal(cstate.map.surf_map.key_hi, tstate.map.surf_map.key_hi)
    with pytest.raises(ValueError, match="static"):
        TP.replay_features_cadenced(feats.map(lambda t: t[:4]), cfg,
                                    device="cpu")


def test_metrics_match():
    rng = np.random.default_rng(4)
    est = rng.normal(size=(20, 3))
    gt = est + rng.normal(scale=0.1, size=(20, 3))
    for align in (False, True):
        np.testing.assert_allclose(
            TMet.ate_rmse(torch.tensor(est), gt, align=align),
            JMet.ate_rmse(est, gt, align=align), rtol=1e-6)
    np.testing.assert_allclose(TMet.rpe_rmse(est, gt, 2),
                               JMet.rpe_rmse(est, gt, 2), rtol=1e-6)


@pytest.mark.parametrize("bad", [
    dict(argv=["--mode", "online"]),
    dict(argv=["--live-port", "0"]),
    dict(argv=["--viz"]),
])
def test_unported_paths_raise(bad, tmp_path):
    """Options outside the ported slice raise, naming their ROADMAP.md
    item, before any work is done (the command line's online mode, live
    viewer and plots)."""
    from loam_tpu_torch import cli

    out = tmp_path / "out"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--synthetic", "1", "--device", "cpu", "--out-dir",
                  str(out)] + bad["argv"])
    assert not out.exists()


def test_port_runs_without_jax(tmp_path):
    """Importing the port and replaying two frames, without and with an
    IMU stream, two scenarios in one batched replay, and the command
    line over a bag with an IMU stream, leaves jax and loam_tpu out of
    sys.modules: the port keeps its own config, synthetic sweeps, bag
    reader and exporters (the machine with the card has no JAX)."""
    fields = dataclasses.asdict(parity_cfg())
    bag = str(tmp_path / "two.bag")
    out_dir = str(tmp_path / "out")
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        sys.path.insert(0, {os.path.join(ROOT, "tests")!r})
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from loam_tpu_torch.config import LoamConfig
        from loam_tpu_torch import pipeline
        from loam_tpu_torch.imu import ImuStream
        from loam_tpu_torch.io import synth
        from torch_parity import make_sweeps
        cfg = LoamConfig(**{fields!r})
        raw, msk, _ = make_sweeps(2, n_azimuth=240)
        outs = pipeline.replay_sweeps(raw, msk, cfg, device="cpu")
        assert torch.isfinite(outs.pose_integrated).all()
        pose_fn = synth.oscillating_trajectory()
        t_scans = np.array([0.06, 0.16], np.float32)
        wins = [synth.simulate_imu_window(pose_fn, t0=float(t))
                for t in t_scans]
        stream = ImuStream(*(torch.tensor(np.stack([w[i] for w in wins]))
                             for i in range(4)))
        outs = pipeline.replay_sweeps(raw, msk, cfg, stream, t_scans,
                                      device="cpu")
        assert torch.isfinite(outs.pose_integrated).all()
        from loam_tpu_torch.parallel import replay
        outs = replay.batched_replay(np.stack([raw, raw[::-1]]),
                                     np.stack([msk, msk[::-1]]), cfg,
                                     device="cpu")
        assert outs.pose_integrated.shape == (2, 2, 6)
        assert torch.isfinite(outs.pose_integrated).all()
        from torch_parity import rpy_to_quat, write_sweep_bag
        from loam_tpu_torch import checkpoint, cli
        from loam_tpu_torch.io import export, rosbag
        t = np.arange(0.0, 0.3, 0.005)
        rpy = np.zeros((t.size, 3))
        acc = np.tile([0.0, 0.0, 9.81], (t.size, 1))
        write_sweep_bag({bag!r}, list(zip(raw, msk)), 10.0 + t_scans,
                        (10.0 + t, rpy_to_quat(rpy), acc))
        raw_b, msk_b, stamps = rosbag.load_sweeps({bag!r})
        assert raw_b.shape[0] == 2 and msk_b.sum() == msk.sum()
        assert cli.main(["--bag", {bag!r}, "--skip", "0", "--device",
                         "cpu", "--ring-width", "512", "--stream-clouds",
                         "--out-dir", {out_dir!r}]) == 0
        _, pos, _ = export.load_trajectory_tum({out_dir!r} + "/integrated.tum")
        assert pos.shape == (2, 3) and np.isfinite(pos).all()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "loam_tpu"))
        print("FOREIGN_MODULES", bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOREIGN_MODULES []" in out.stdout, out.stdout
