"""loam_tpu's corrected-semantics mode through loam_tpu_torch (CPU, plain
kernel versions): fresh Gauss-Newton rows every odometry iteration
(odom_accumulate_rows=False) and the whole upward correspondence walk
(emulate_upward_scan_truncation=False), the pair that
tests/test_odometry.py's CFG_FRESH and tests/test_long_sequence.py's CFG
run.

- With fresh rows alone, one odometry step from loam_tpu's state is held
  to loam_tpu op by op (1e-6 rad / 1e-5 m), as test_torch_odometry.py
  holds the default mode.
- Without the truncation the upward walk reaches the whole previous
  cloud, and a few more near-ties meet.  loam_tpu ranks candidates by
  |q|^2 - 2 q.r + |r|^2 on absolute coordinates (loam_tpu/ops/nn.py),
  the port by (q - r)^2: every correspondence that differs must be one
  where the port's point is strictly nearer in exact float64 distance
  and loam_tpu's expanded form ranks the two the other way round.
- Whole 5-frame replays in that mode are held to loam_tpu's jitted
  replay at the batch's bound (1e-4 rad / 1e-3 m), with the same
  mapping cadence; a replay split around a checkpoint equals the
  uninterrupted one bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, odometry as JO, pipeline as JP
from loam_tpu.ops import nn as JNN
from loam_tpu.ops.deskew import transform_to_start as j_to_start
from loam_tpu.ops.features import extract_features as j_extract

from loam_tpu_torch import checkpoint as CK, odometry as TO, pipeline as TP
from loam_tpu_torch.ops.cuda.odom_corr import walk_masks
from loam_tpu_torch.state import pipeline_state_from_numpy
from loam_tpu_torch.types import tree_map

from torch_parity import (feats_to_torch, make_sweeps, parity_cfg,
                          pose_errors, to_port_cfg, tree_to_numpy)

torch.set_num_threads(1)

FRAMES = 5
SEED = 3
FRESH_ROWS = dict(odom_accumulate_rows=False)
CORRECTED = dict(odom_accumulate_rows=False,
                 emulate_upward_scan_truncation=False)
POSES = ("pose_odom", "pose_aft", "pose_integrated")
# the perturbed transform of test_torch_odometry.py's
# test_correspondences_match_jnp_walks
PERTURBED = (0.002, -0.01, 0.001, 0.01, 0.0, 0.08)
MAX_NEAR_TIES = 8    # a cloud's mismatches allowed (4 of 292 measured)


@pytest.fixture(scope="module")
def sweeps():
    raw, msk, _ = make_sweeps(FRAMES, seed=SEED)
    return raw, msk


def _odom_chain(cfg, raw, msk, frames):
    """loam_tpu's odometry op by op over the first `frames` sweeps: the
    state before each frame and each frame's features."""
    state = JO.OdomState.create(cfg)
    states, feats = [], []
    for k in range(frames):
        f = j_extract(JF.ingest_sweep(jnp.asarray(raw[k]),
                                      jnp.asarray(msk[k]), cfg), cfg)
        states.append(state)
        feats.append(f)
        state, _ = JO.odometry_step(state, f, None, cfg)
    return states, feats


def _port_odom(jcfg, jstate):
    """A loam_tpu OdomState as the port's, on the CPU."""
    tree = tree_to_numpy(dataclasses.replace(JP.PipelineState.create(jcfg),
                                             odom=jstate))
    return pipeline_state_from_numpy(tree, device="cpu").odom


@pytest.fixture(scope="module")
def fresh_rows_chain(sweeps):
    cfg = parity_cfg(**FRESH_ROWS)
    return (cfg,) + _odom_chain(cfg, *sweeps, 3)


@pytest.mark.parametrize("frame", [1, 2])
def test_fresh_rows_odometry_step_matches(fresh_rows_chain, frame):
    """odom_accumulate_rows=False alone: one odometry step from
    loam_tpu's state, teacher-forced, against loam_tpu op by op."""
    cfg, states, feats = fresh_rows_chain
    jstate, jout = JO.odometry_step(states[frame], feats[frame], None, cfg)
    tnew, tout = TO.odometry_step(_port_odom(cfg, states[frame]),
                                  feats_to_torch(feats[frame]),
                                  to_port_cfg(cfg))
    rot, trans = pose_errors(tout.pose.numpy(), jout.pose)
    assert rot < 1e-6 and trans < 1e-5, (frame, rot, trans)
    rot, trans = pose_errors(tnew.transform.numpy(), jstate.transform)
    assert rot < 1e-6 and trans < 1e-5, (frame, rot, trans)
    assert np.abs(np.asarray(jout.pose[3:])).max() > 0.005   # it moved
    assert bool(tout.publish_to_mapping) == bool(jout.publish_to_mapping)
    assert int(tnew.nan_skips) == int(jstate.nan_skips)
    # fresh rows move the step away from the accumulated default
    dcfg = parity_cfg()
    _, dout = TO.odometry_step(_port_odom(dcfg, states[frame]),
                               feats_to_torch(feats[frame]),
                               to_port_cfg(dcfg))
    assert pose_errors(dout.pose.numpy(), tout.pose.numpy())[1] > 1e-6


@pytest.fixture(scope="module")
def corrected_frame1(sweeps):
    """loam_tpu's odometry state after frame 0 and frame 1's features,
    in the corrected-semantics configuration."""
    cfg = parity_cfg(**CORRECTED)
    states, feats = _odom_chain(cfg, *sweeps, 2)
    return cfg, states[1], feats[1]


@pytest.mark.parametrize("transform", ["identity", "perturbed"])
def test_untruncated_walk_mismatches_are_reference_near_ties(
        corrected_frame1, transform):
    """_odom_associate with both knobs off: the integer outputs equal
    loam_tpu's except where the port's pick is strictly nearer, and for
    each such pick loam_tpu's expanded-form distance ranks the two
    points the other way round."""
    cfg, jstate, feats = corrected_frame1
    x = np.zeros(6, np.float32) if transform == "identity" \
        else np.array(PERTURBED, np.float32)
    j = [np.asarray(a) for a in JO._odom_associate(
        jnp.asarray(x), feats, jstate.corner_last, jstate.surf_last, cfg)]
    tstate = _port_odom(cfg, jstate)
    tfeats = feats_to_torch(feats)
    t = [a.numpy() for a in TO._odom_associate(
        torch.tensor(x), tfeats, tstate.corner_last, tstate.surf_last,
        to_port_cfg(cfg))]
    # the 1-NN is not walked: it must agree everywhere
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[2], j[2])

    mismatches = 0
    for cloud, last, j1, outs in (
            (feats.sharp, jstate.corner_last, j[0], ((j[1], t[1]),)),
            (feats.flat, jstate.surf_last, j[2],
             ((j[3], t[3]), (j[4], t[4])))):
        proj = np.asarray(j_to_start(cloud.xyz, cloud.sweep_time(),
                                     jnp.asarray(x)))
        ref = np.asarray(last.xyz)
        expanded = np.asarray(JNN.pairwise_sq_dists(
            jnp.asarray(proj), last.xyz, last.mask))
        up, dn, _, _ = walk_masks(
            torch.tensor(np.asarray(last.ring()))[None],
            torch.tensor(j1)[None], torch.tensor([int(cloud.count())],
                                                 dtype=torch.int32),
            torch.tensor([int(last.count())], dtype=torch.int32),
            window=cfg.ring_window, truncate=False)
        walked = (up | dn)[0].numpy()
        cloud_bad = 0
        for ja, ta in outs:
            for i in np.nonzero(ja != ta)[0]:
                a, b = int(ja[i]), int(ta[i])
                assert a >= 0 and b >= 0, (i, a, b)
                assert walked[i, a] and walked[i, b], (i, a, b)
                q = proj[i].astype(np.float64)
                d_a = float(((q - ref[a].astype(np.float64)) ** 2).sum())
                d_b = float(((q - ref[b].astype(np.float64)) ** 2).sum())
                assert d_b < d_a, (i, a, b, d_a, d_b)
                assert (expanded[i, a], a) < (expanded[i, b], b), \
                    (i, a, b, expanded[i, a], expanded[i, b])
                print(f"{transform}: query {i}: loam_tpu {a} at {d_a:.7g}, "
                      f"the port {b} at {d_b:.7g} m^2 (expanded form "
                      f"{expanded[i, a]:.7g} / {expanded[i, b]:.7g})")
                cloud_bad += 1
        print(f"{transform}: {cloud_bad} near-tie mismatches of "
              f"{int(cloud.count())} queries")
        assert cloud_bad <= MAX_NEAR_TIES
        mismatches += cloud_bad
    # the untruncated walk reaches past the current feature count
    n_q = int(feats.flat.count())
    assert (t[3] >= n_q).any() or (t[4] >= n_q).any()
    print(f"{transform}: {mismatches} mismatches in all")


@pytest.fixture(scope="module")
def port_replays(sweeps):
    """The port's 5-frame replays, by mode: strict and hybrid in the
    corrected-semantics configuration, strict with the default knobs."""
    raw, msk = sweeps
    out = {}
    for name, over in (("strict", CORRECTED),
                       ("hybrid", dict(CORRECTED,
                                       map_exact_regather_every=5)),
                       ("default", {})):
        cfg = to_port_cfg(parity_cfg(**over))
        out[name] = TP.replay_sweeps(raw, msk, cfg, device="cpu",
                                     return_state=True)
    return out


@pytest.mark.parametrize("mode", ["strict", "hybrid"])
def test_corrected_semantics_replay_matches_loam_tpu(sweeps, port_replays,
                                                     mode):
    raw, msk = sweeps
    over = dict(CORRECTED)
    if mode == "hybrid":
        over["map_exact_regather_every"] = 5
    cfg = parity_cfg(**over)
    jout = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg)
    tout, _ = port_replays[mode]
    np.testing.assert_array_equal(tout.mapped.numpy(),
                                  np.asarray(jout.mapped))
    for name in POSES:
        got = getattr(tout, name).numpy()
        assert np.isfinite(got).all()
        rot, trans = pose_errors(got, getattr(jout, name))
        print(f"{mode} {name}: {rot:.3g} rad, {trans:.3g} m")
        assert rot < 1e-4 and trans < 1e-3, (name, rot, trans)
    # the knobs move the trajectory
    default = port_replays["default"][0].pose_integrated.numpy()
    moved = pose_errors(tout.pose_integrated.numpy(), default)[1]
    assert moved > 1e-6, moved


def test_corrected_semantics_checkpoint_resume(sweeps, port_replays,
                                               tmp_path):
    """The strict corrected-semantics replay split after frame 2 around a
    CheckpointManager save and restore equals the uninterrupted one bit
    for bit."""
    raw, msk = sweeps
    cfg = to_port_cfg(parity_cfg(**CORRECTED))
    whole, whole_state = port_replays["strict"]
    first, mid = TP.replay_sweeps(raw[:3], msk[:3], cfg, device="cpu",
                                  return_state=True)
    ck = CK.CheckpointManager(str(tmp_path / "ck"))
    ck.save(3, mid, metadata={"frame": 3})
    restored, meta = CK.CheckpointManager(str(tmp_path / "ck")).restore(
        None, TP.PipelineState.create(cfg, "cpu"))
    assert meta == {"frame": 3}
    rest, final = TP.replay_sweeps(raw[3:], msk[3:], cfg, device="cpu",
                                   state0=restored, return_state=True)
    for name in POSES + ("mapped",):
        got = torch.cat([getattr(first, name), getattr(rest, name)])
        assert torch.equal(got, getattr(whole, name)), name
    a, b = [], []
    tree_map(a.append, final)
    tree_map(b.append, whole_state)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ck.close()
