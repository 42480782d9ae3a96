"""The port's offline command line (loam_tpu_torch/cli.py, `python -m
loam_tpu_torch`) against loam_tpu's, on the CPU (--device cpu, the
kernels' plain versions).

Its inputs must be loam_tpu.cli's bit for bit (the synthetic recipe, a
bag's sweeps and IMU stream), the IMU windows within 1 ulp (the
conversion's sin and cos are the two libraries' own), its trajectories
those of pipeline.replay_sweeps on the same sweeps, and its cloud
streams those that the cadence rule predicts.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from loam_tpu import cli as JC

from loam_tpu_torch import cli as TC, pipeline as TP
from loam_tpu_torch.io import export, synth

from test_cli_golden_compare import _write_synth_bag
from torch_parity import (parity_cfg, raw_imu, rpy_to_quat, to_port_cfg,
                          write_sweep_bag)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUMS = ("odom", "aft_mapped", "integrated")


@pytest.fixture(scope="module")
def imu_bag(tmp_path_factory):
    """Three sweeps of 240 azimuths along the oscillating trajectory with
    its 200 Hz IMU stream as raw sensor_msgs/Imu messages."""
    world = synth.make_world(seed=11)
    pose_fn = synth.oscillating_trajectory()
    t_scans = 0.06 + 0.1 * np.arange(3)
    sweeps = [synth.simulate_sweep_traj(world, pose_fn, t0=float(t),
                                        n_azimuth=240, seed=11 + k)
              for k, t in enumerate(t_scans)]
    imu_t = np.arange(0.0, 0.5, 1.0 / 200.0)
    pyr = np.stack([pose_fn(t)[:3] for t in imu_t])
    acc = np.random.default_rng(1).normal(size=pyr.shape)
    rpy, acc_v = raw_imu(pyr, acc)
    path = str(tmp_path_factory.mktemp("bag") / "imu.bag")
    write_sweep_bag(path, sweeps, 50.0 + t_scans,
                    (50.0 + imu_t, rpy_to_quat(rpy), acc_v))
    return path


def _load(pkg, argv):
    args = pkg.build_parser().parse_args(argv)
    return pkg._load_data(args, pkg._config(args))


@pytest.mark.parametrize("source", ["synthetic", "bag", "bag_skip"])
def test_load_data_matches_loam_tpu(imu_bag, source):
    argv = {"synthetic": ["--synthetic", "3"],
            "bag": ["--bag", imu_bag, "--skip", "0"],
            "bag_skip": ["--bag", imu_bag, "--skip", "1"]}[source]
    argv += ["--ring-width", "512"]
    got, want = _load(TC, argv), _load(JC, argv)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if source == "synthetic":
        assert got[3] is None and want[3] is None
        return
    assert got[0].shape[0] == (3 if source == "bag" else 2)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)


def test_window_imu_matches_loam_tpu(imu_bag):
    """The same windows; the converted stream within 1 ulp."""
    argv = ["--bag", imu_bag, "--skip", "0", "--ring-width", "512"]
    cfg = TC._config(TC.build_parser().parse_args(argv))
    _, _, stamps, (t, rpy, acc) = _load(TC, argv)
    base = stamps[0]
    got = TC._window_imu(t - base, rpy, acc, stamps - base, cfg,
                         device="cpu")
    want = JC._window_imu(t - base, rpy, acc, stamps - base,
                          JC._config(JC.build_parser().parse_args(argv)))
    assert got.t.shape == (3, 256)
    assert int(got.mask.sum()) > 3 * 20
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
    np.testing.assert_array_equal(got.rpy.numpy(), np.asarray(want.rpy))
    # acc = a - sin(roll) cos(pitch) g: within 1 ulp of the gravity
    # term, which cancels to values far smaller than it
    np.testing.assert_allclose(got.acc.numpy(), np.asarray(want.acc),
                               rtol=0, atol=np.spacing(np.float32(9.81)))


def _replay_tums(tmp_path, argv, outs):
    """The TUM files of a replay's outputs, written as the CLI does."""
    _, _, stamps, _ = _load(TC, argv)
    ref = tmp_path / "ref"
    ref.mkdir()
    for name, field in zip(TUMS, ("pose_odom", "pose_aft",
                                  "pose_integrated")):
        export.save_trajectory_tum(str(ref / f"{name}.tum"), stamps,
                                   getattr(outs, field).numpy())
    return ref


def test_cli_synthetic_on_cpu(tmp_path, capsys):
    out = tmp_path / "out"
    argv = ["--synthetic", "3", "--ring-width", "512"]
    assert TC.main(argv + ["--device", "cpu", "--out-dir", str(out),
                           "--report-timing"]) == 0
    assert "replay" in capsys.readouterr().out
    raw, msk, _, _ = _load(TC, argv)
    cfg = TC._config(TC.build_parser().parse_args(argv))
    outs = TP.replay_sweeps(raw, msk, cfg, device="cpu")
    ref = _replay_tums(tmp_path, argv, outs)
    for name in TUMS:
        assert (out / f"{name}.tum").read_bytes() == \
            (ref / f"{name}.tum").read_bytes(), name
        t, pos, _ = export.load_trajectory_tum(str(out / f"{name}.tum"))
        assert t.shape == (3,) and np.isfinite(pos).all()
    surround = export.load_cloud_ply(str(out / "map_surround.ply"))
    assert surround.shape[0] > 1000 and np.isfinite(surround).all()


def test_cli_without_card_raises(tmp_path, monkeypatch):
    """Without --device cpu the CLI runs on the card, and where there is
    none it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TC.main(["--synthetic", "1", "--out-dir", str(tmp_path)])


def test_stream_clouds_cadence(tmp_path, monkeypatch):
    """Chunks of map_frame_num * (skip_frame_num + 1) sweeps (2 here):
    5 sweeps map at frames 1 and 3 and end chunks at frames 1, 3 and 4.
    The chunked replay carries its state, so its poses and registered
    clouds are those of one replay of all five sweeps.  The tiny test
    configuration (parity_cfg, its rings of 512) stands in for the CLI's
    full-size maps, whose exact k-NN takes minutes on the CPU."""
    cfg = to_port_cfg(parity_cfg(map_frame_num=1))
    monkeypatch.setattr(TC, "_config", lambda args: cfg)
    out = tmp_path / "out"
    argv = ["--synthetic", "5", "--ring-width", "512"]
    assert TC.main(argv + ["--device", "cpu", "--out-dir", str(out),
                           "--stream-clouds"]) == 0
    clouds = sorted(os.listdir(out / "clouds"))
    assert clouds == ["registered_0001.ply", "registered_0003.ply",
                      "surround_0001.ply", "surround_0003.ply",
                      "surround_0004.ply"]
    raw, msk, _, _ = _load(TC, argv)
    outs = TP.replay_sweeps(raw, msk, dataclasses.replace(
        cfg, emit_registered=True), device="cpu")
    ref = _replay_tums(tmp_path, argv, outs)
    for name in TUMS:
        assert (out / f"{name}.tum").read_bytes() == \
            (ref / f"{name}.tum").read_bytes(), name
    for k in (1, 3):
        got = export.load_cloud_ply(str(out / "clouds"
                                        / f"registered_{k:04d}.ply"))
        reg = outs.registered
        np.testing.assert_array_equal(got, reg.xyz[k][reg.mask[k]].numpy())


def test_golden_compare_on_synthetic_bag(tmp_path, capsys):
    """--golden-compare on the 4-sweep synthetic bag of
    test_cli_golden_compare.py: both trajectory sets and a passing
    verdict line.  At 300 azimuths in rings of 512 neither the port nor
    the oracle finds enough features to solve, so both stay at the
    origin: this checks the plumbing of the comparison; its accuracy is
    checked on the card at full density (chip_smoke.py phase 8)."""
    bag = str(tmp_path / "synth.bag")
    F = _write_synth_bag(bag)
    out = tmp_path / "out"
    rc = TC.main(["--bag", bag, "--skip", "0", "--imu-topic", "",
                  "--ring-width", "512", "--device", "cpu",
                  "--out-dir", str(out), "--golden-compare"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    verdict = json.loads(lines[-1])["golden_compare"]
    assert verdict["gate_cm"] == 5.0 and verdict["pass"], verdict
    assert rc == 0
    for name in ("integrated", "golden_integrated", "golden_odom",
                 "golden_aft_mapped"):
        t, pos, _ = export.load_trajectory_tum(str(out / f"{name}.tum"))
        assert t.shape == (F,) and np.isfinite(pos).all()


def test_module_help():
    r = subprocess.run([sys.executable, "-m", "loam_tpu_torch", "--help"],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("usage: loam_tpu_torch")
    assert "--device" in r.stdout
