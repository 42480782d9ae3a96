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

from torch_parity import make_sweeps, parity_cfg, pose_errors

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 5


@pytest.fixture(scope="module")
def replays():
    cfg = parity_cfg()
    raw, msk, poses = make_sweeps(FRAMES, seed=3)
    jouts = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg)
    touts, tstate = TP.replay_sweeps(torch.tensor(raw), torch.tensor(msk),
                                     cfg, return_state=True)
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
    feats = extract_features(TF.ingest_sweep(torch.tensor(raw),
                                             torch.tensor(msk), cfg), cfg)
    couts, cstate = TP.replay_features_cadenced(feats, cfg)
    for name in ("pose_odom", "pose_aft", "pose_integrated", "mapped"):
        assert torch.equal(getattr(couts, name), getattr(touts, name)), name
    assert torch.equal(cstate.map.surf_map.key_hi, tstate.map.surf_map.key_hi)
    with pytest.raises(ValueError, match="static"):
        TP.replay_features_cadenced(feats.map(lambda t: t[:4]), cfg)


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
    dict(imu=True), dict(cfg=dict(emit_registered=True)),
    dict(cfg=dict(map_exact_knn=False)),
    dict(cfg=dict(map_exact_regather_every=5)),
    dict(cfg=dict(select_argmax=True)),
])
def test_unported_paths_raise(bad):
    """Configurations outside the ported slice raise, naming their
    ROADMAP.md item, before any work is done."""
    cfg = dataclasses.replace(parity_cfg(), **bad.get("cfg", {}))
    raw = torch.zeros(1, 64, 3)
    msk = torch.zeros(1, 64, dtype=torch.bool)
    kw = dict(imu_streams=object(), t_scans=torch.zeros(1)) \
        if bad.get("imu") else {}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TP.replay_sweeps(raw, msk, cfg, **kw)


def test_port_runs_without_jax():
    """Importing the port and replaying two frames leaves jax out of
    sys.modules (the machine with the card has no JAX)."""
    fields = dataclasses.asdict(parity_cfg())
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        sys.path.insert(0, {os.path.join(ROOT, "tests")!r})
        import torch
        torch.set_num_threads(1)
        from loam_tpu.config import LoamConfig
        from loam_tpu_torch import pipeline
        from torch_parity import make_sweeps
        raw, msk, _ = make_sweeps(2, n_azimuth=240)
        outs = pipeline.replay_sweeps(torch.tensor(raw), torch.tensor(msk),
                                      LoamConfig(**{fields!r}))
        assert torch.isfinite(outs.pose_integrated).all()
        bad = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
        print("JAX_MODULES", bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "JAX_MODULES []" in out.stdout, out.stdout
