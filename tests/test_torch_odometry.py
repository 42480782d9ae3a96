"""loam_tpu_torch odometry against loam_tpu from the same mid-run state
(CPU, plain kernel versions).

Correspondences are integer outputs and must be identical.  Poses go
through an LU solve, a 6x6 eigendecomposition and sums taken in another
order (XLA:CPU vs PyTorch), so they are held to 1e-5 m / 1e-6 rad.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, odometry as JO, pipeline as JP
from loam_tpu.ops.features import extract_features as j_extract

from loam_tpu_torch import odometry as TO
from loam_tpu_torch.state import pipeline_state_from_numpy

from torch_parity import (feats_to_torch, make_sweeps, parity_cfg,
                          pose_errors, to_port_cfg, tree_to_numpy)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mid_run():
    """JAX state after frames 0-1 and the JAX features of frame 2."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(3, seed=5)
    _, st = JP.replay_sweeps(jnp.asarray(raw[:2]), jnp.asarray(msk[:2]), cfg,
                             return_state=True)
    sweep = JF.ingest_sweep(jnp.asarray(raw[2]), jnp.asarray(msk[2]), cfg)
    feats = j_extract(sweep, cfg)
    return cfg, st, feats


def test_correspondences_match_jnp_walks(mid_run):
    """One re-association at a perturbed transform: the port's kernels
    (1-NN + ring walk) pick the same points as the JAX CPU path."""
    cfg, st, feats = mid_run
    transform = np.array([0.002, -0.01, 0.001, 0.01, 0.0, 0.08], np.float32)
    j = JO._odom_associate(jnp.asarray(transform), feats, st.odom.corner_last,
                           st.odom.surf_last, cfg)
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    t = TO._odom_associate(torch.tensor(transform), feats_to_torch(feats),
                           tstate.odom.corner_last, tstate.odom.surf_last,
                           to_port_cfg(cfg))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (t[1].numpy() >= 0).sum() > 10 and (t[4].numpy() >= 0).sum() > 100


def test_odometry_step_matches(mid_run):
    cfg, st, feats = mid_run
    jstate, jout = JO.odometry_step(st.odom, feats, None, cfg)
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    tnew, tout = TO.odometry_step(tstate.odom, feats_to_torch(feats),
                                  to_port_cfg(cfg))
    rot, trans = pose_errors(tout.pose.numpy(), jout.pose)
    assert rot < 1e-6 and trans < 1e-5, (rot, trans)
    assert np.abs(np.asarray(jout.pose[3:])).max() > 0.05  # it moved
    assert bool(tout.publish_to_mapping) == bool(jout.publish_to_mapping)
    assert int(tnew.frame_count) == int(jstate.frame_count)
    assert int(tnew.nan_skips) == int(jstate.nan_skips)
    for name in ("corner_last", "surf_last"):
        a, b = getattr(jout, name), getattr(tout, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_array_equal(b.rel.numpy(), np.asarray(a.rel))
        np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz),
                                   atol=1e-5)


def test_init_frame_and_unsolvable_frame():
    """The first frame hands the clouds over without a pose; a frame
    whose previous clouds are too small keeps the warm-start transform."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(1, seed=5)
    feats = j_extract(JF.ingest_sweep(jnp.asarray(raw[0]),
                                      jnp.asarray(msk[0]), cfg), cfg)
    tf = feats_to_torch(feats)
    cfg = to_port_cfg(cfg)
    s0 = TO.OdomState.create(cfg, device="cpu")
    s1, out = TO.odometry_step(s0, tf, cfg)
    assert bool(s1.initialized) and not bool(out.publish_to_mapping)
    assert torch.equal(out.pose, torch.zeros(6))
    assert torch.equal(s1.corner_last.xyz, tf.less_sharp.xyz)
    empty = dataclasses.replace(s1, corner_last=s0.corner_last)
    s2, out2 = TO.odometry_step(empty, tf, cfg)
    assert torch.equal(s2.transform, torch.zeros(6))
    assert bool(out2.publish_to_mapping)
    jax.clear_caches()
