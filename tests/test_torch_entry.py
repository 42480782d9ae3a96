"""loam_tpu_torch.entry against __graft_entry__ (CPU): the configurations
field by field, the example inputs bit for bit, two frames of the
one-frame forward against the jitted reference forward (pose and
odometry state at 1e-4 rad / 1e-3 m), the forward stepped over a replay's
sweeps against that replay bit for bit, and the one-rank dry run."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from bench import _cfg as bench_cfg

from loam_tpu_torch import entry as E
from loam_tpu_torch import pipeline as TP

from torch_parity import make_sweeps, parity_cfg, pose_errors, to_port_cfg

torch.set_num_threads(1)


def test_configs_equal_the_reference():
    assert E.tiny_cfg() == to_port_cfg(GE._tiny_cfg())
    assert E.bench_cfg() == to_port_cfg(bench_cfg())
    changed = {f.name for f in dataclasses.fields(E.bench_cfg())
               if getattr(E.bench_cfg(), f.name)
               != getattr(type(E.bench_cfg())(), f.name)}
    assert "map_exact_regather_every" in changed
    assert E.bench_cfg().ring_width == 2048


@pytest.mark.parametrize("batch,frames,seed", [(None, 2, 0), (None, 1, 0),
                                               (3, 2, 5)])
def test_example_inputs_equal_the_reference(batch, frames, seed):
    cfg = E.tiny_cfg()
    raw, msk = E.example_inputs(cfg, batch=batch, frames=frames, seed=seed)
    jraw, jmsk = GE._example_inputs(GE._tiny_cfg(), batch=batch,
                                    frames=frames, seed=seed)
    assert raw.dtype == jraw.dtype and msk.dtype == jmsk.dtype
    np.testing.assert_array_equal(raw, jraw)
    np.testing.assert_array_equal(msk, jmsk)


def test_forward_matches_the_reference_entry():
    """Two frames of the port's forward against __graft_entry__.entry()'s
    jitted forward, each from its own example state: the integrated pose
    and the odometry state."""
    fn, (raw0, msk0, state) = E.entry(device="cpu")
    jfn, (jraw0, jmsk0, jstate) = GE.entry()
    np.testing.assert_array_equal(raw0.numpy(), np.asarray(jraw0))
    np.testing.assert_array_equal(msk0.numpy(), np.asarray(jmsk0))
    jfn = jax.jit(jfn)
    raw, msk = E.example_inputs(E.tiny_cfg(), frames=2)
    for k in range(2):
        state, pose = fn(torch.tensor(raw[k]), torch.tensor(msk[k]), state)
        jstate, jpose = jfn(raw[k], msk[k], jstate)
        assert pose.shape == (6,) and torch.isfinite(pose).all()
        rot, trans = pose_errors(pose.numpy(), np.asarray(jpose))
        assert rot < 1e-4 and trans < 1e-3, (k, rot, trans)
        for name in ("transform", "transform_sum"):
            rot, trans = pose_errors(getattr(state.odom, name).numpy(),
                                     np.asarray(getattr(jstate.odom, name)))
            assert rot < 1e-4 and trans < 1e-3, (k, name, rot, trans)
        assert bool(state.odom.initialized) == bool(jstate.odom.initialized)
        assert int(state.odom.frame_count) == int(jstate.odom.frame_count)
    assert bool(state.odom.initialized)


def test_forward_stepped_equals_the_replay():
    """The forward, one sweep at a time at the parity configuration,
    equals replay_sweeps of the same sweeps bit for bit: one sweep
    rounds as a frame batch does."""
    cfg = to_port_cfg(parity_cfg())
    raw, msk, _ = make_sweeps(4, seed=3)
    fn, (_, _, state) = E.entry(device="cpu", cfg=cfg)
    poses = []
    for k in range(raw.shape[0]):
        state, pose = fn(torch.tensor(raw[k]), torch.tensor(msk[k]), state)
        poses.append(pose)
    ref = TP.replay_sweeps(raw, msk, cfg, device="cpu")
    assert torch.equal(torch.stack(poses), ref.pose_integrated)
    assert ref.mapped.any() and ref.pose_integrated.abs().max() > 0.1


def test_dryrun_multichip_on_one_rank():
    outs = E.dryrun_multichip(1, E.tiny_cfg(), device="cpu")
    assert len(outs) == 1
    assert outs[0].pose_integrated.shape == (1, 6)
    assert torch.isfinite(outs[0].pose_integrated).all()


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device"):
        E.entry()
