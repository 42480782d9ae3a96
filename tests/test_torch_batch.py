"""loam_tpu_torch's scenario-batched replay (parallel/replay.py) against
its own single-scenario replay and against loam_tpu's batched replay
(CPU, plain kernel versions).

B scenarios in one call run in lockstep through one recurrent core; a
scenario that converges early, or cannot solve, is frozen by its own
mask.  So the batch must equal B single replays bit for bit, in every
mapping mode: no op of the core rounds differently with the number of
scenarios beside it.  Against loam_tpu's vmapped replay the poses are
held per scenario and frame to rot 1e-4 rad / trans 1e-3 m, the bounds
of test_torch_pipeline.py, with the mapping cadence identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import pipeline as JP
from loam_tpu.ops import features as JFT
from loam_tpu.parallel import replay as JR

from loam_tpu_torch import frontend as TF, mapping as TMap, odometry as TO
from loam_tpu_torch import pipeline as TP
from loam_tpu_torch.ops import features as TFT
from loam_tpu_torch.parallel import replay as TR
from loam_tpu_torch.state import pipeline_state_from_numpy

from torch_parity import (feats_to_torch, make_sweeps, parity_cfg,
                          pose_errors, to_port_cfg, tree_to_numpy)

torch.set_num_threads(1)

FRAMES = 5
POSES = ("pose_odom", "pose_aft", "pose_integrated")
# several re-association rounds an odometry frame and two or more
# mapping rounds a mapping frame, so that the scenarios leave the loops
# at different times
LOCKSTEP = dict(odom_max_iters=12, reassociate_every=2, map_max_iters=6)
# mode -> (config changes, the fast scenario that takes the most mapping
# iterations in that mode: world seed, speed m/s, yaw rate rad/s)
MODES = {
    "strict": ({}, (5, 1.5, 0.35)),
    # scenario 0's first solve drifts past 0.12 m inside a round and
    # re-gathers; scenario 2's does not
    "hybrid": (dict(map_exact_regather_every=3, knn_regather_drift=0.12),
               (5, 1.5, 0.35)),
    "cells": (dict(map_exact_knn=False, map_regather_every=1),
              (7, 2.0, 0.5)),
}


def _lockstep_scenarios(fast):
    """Three scenarios that behave differently: 0 converges early, 1 sees
    one point in 40 and can never solve, 2 moves fast and takes the most
    mapping iterations."""
    raw0, msk0, _ = make_sweeps(FRAMES, seed=3)
    raw1, msk1, _ = make_sweeps(FRAMES, seed=7)
    msk1 = msk1 & (np.arange(msk1.shape[1]) % 40 == 0)
    seed, speed, yaw_rate = fast
    raw2, msk2, _ = make_sweeps(FRAMES, seed=seed, speed=speed,
                                yaw_rate=yaw_rate)
    return np.stack([raw0, raw1, raw2]), np.stack([msk0, msk1, msk2])


class _Counts:
    """Counts, per replay, the odometry and mapping solves entered, the
    mapping iterations and the hybrid gathers (one k-NN call a map)."""

    def __init__(self, monkeypatch, cfg):
        self.runs = []
        gn_odom, gn_map = TO.gauss_newton_odometry, TMap.gauss_newton_mapping
        iteration, knn = TMap._map_iteration, TMap.knn_points

        def count(name, fn, when=lambda *a, **k: True):
            def spy(*args, **kw):
                if self.runs and when(*args, **kw):
                    self.runs[-1][name] += 1
                return fn(*args, **kw)
            return spy

        monkeypatch.setattr(TO, "gauss_newton_odometry",
                            count("odometry_solves", gn_odom))
        monkeypatch.setattr(TMap, "gauss_newton_mapping",
                            count("mapping_solves", gn_map))
        monkeypatch.setattr(TMap, "_map_iteration",
                            count("iterations", iteration))
        monkeypatch.setattr(TMap, "knn_points", count(
            "gathers", knn, lambda q, ref, mask, k, **kw: k > cfg.map_knn))

    def start(self):
        self.runs.append(dict(odometry_solves=0, mapping_solves=0,
                              iterations=0, gathers=0))
        return self.runs[-1]


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_equals_single_replays(mode, monkeypatch):
    """B=3 scenarios in one batched_replay equal three replay_sweeps
    calls bit for bit: poses, cadence.  The single runs show that the
    three scenarios leave the loops at different times (and, in the
    hybrid mode, that only scenario 0 re-gathers on drift), so the
    batch has frozen each one by its own mask."""
    changes, fast = MODES[mode]
    cfg = to_port_cfg(parity_cfg(**LOCKSTEP, **changes))
    raw, msk = _lockstep_scenarios(fast)
    counts = _Counts(monkeypatch, cfg)
    counts.start()
    batched = TR.batched_replay(raw, msk, cfg, device="cpu")
    singles, runs = [], []
    for b in range(3):
        runs.append(counts.start())
        singles.append(TP.replay_sweeps(raw[b], msk[b], cfg, device="cpu"))
    for b, single in enumerate(singles):
        for name in POSES + ("mapped",):
            assert torch.equal(getattr(batched, name)[b],
                               getattr(single, name)), (mode, b, name)
    assert torch.isfinite(batched.pose_integrated).all()

    early, never, most = runs
    assert never["odometry_solves"] == never["mapping_solves"] == 0
    assert torch.equal(singles[1].pose_integrated,
                       torch.zeros(FRAMES, 6))
    assert early["mapping_solves"] == most["mapping_solves"] > 0
    assert 0 < early["iterations"] < most["iterations"], runs
    assert counts.runs[0]["iterations"] == most["iterations"]
    if mode == "hybrid":
        rounds = [r["iterations"] // cfg.map_exact_regather_every
                  for r in (early, most)]
        # two k-NN calls (corner and surf maps) a gather
        regathers = [r["gathers"] // 2 - n for r, n in zip((early, most),
                                                          rounds)]
        assert regathers[0] > 0 and regathers[1] == 0, (runs, rounds)


# Straight scenarios: (world seed, speed m/s, yaw rate rad/s).  Not
# every straight scenario of this tiny configuration holds the
# whole-replay bound against the jitted reference: its first solving
# mapping frame amplifies rounding, and the jitted reference does not
# reproduce its own op-by-op run there (ROADMAP.md section 3 lists the
# scenarios tried and their gaps).
STRAIGHT = ((3, 0.9, 0.12), (6, 0.8, -0.12), (2, 0.9, 0.12))


@pytest.fixture(scope="module")
def straight():
    """Three straight scenarios (different worlds, speeds and yaw rates)
    and loam_tpu's vmapped replay of them."""
    cfg = parity_cfg()
    scen = [make_sweeps(FRAMES, seed=s, speed=v, yaw_rate=w)
            for s, v, w in STRAIGHT]
    raw = np.stack([s[0] for s in scen])
    msk = np.stack([s[1] for s in scen])
    jouts = jax.jit(lambda x, m: JR._batched_replay(x, m, cfg))(
        jnp.asarray(raw), jnp.asarray(msk))
    jfeats = jax.jit(lambda x, m: JR.batched_frontend(x, m, cfg))(
        jnp.asarray(raw), jnp.asarray(msk))
    return cfg, raw, msk, jouts, jfeats


def _assert_close_to_jax(touts, jouts):
    np.testing.assert_array_equal(touts.mapped.numpy(),
                                  np.asarray(jouts.mapped))
    over = []
    for name in POSES:
        t, j = getattr(touts, name).numpy(), np.asarray(getattr(jouts, name))
        for b in range(t.shape[0]):
            for k in range(t.shape[1]):
                rot, trans = pose_errors(t[b, k], j[b, k])
                if not (rot < 1e-4 and trans < 1e-3):
                    over.append((name, b, k, rot, trans))
    assert not over, over


def test_batched_replay_matches_loam_tpu(straight):
    """batched_replay against loam_tpu.parallel.replay._batched_replay
    on the same NumPy sweeps, per scenario and frame."""
    cfg, raw, msk, jouts, _ = straight
    touts = TR.batched_replay(raw, msk, to_port_cfg(cfg), device="cpu")
    assert touts.pose_odom.shape == (3, FRAMES, 6)
    assert touts.mapped.numpy().sum() == 3 * 2
    _assert_close_to_jax(touts, jouts)
    # the scenarios went their own ways
    end = touts.pose_integrated.numpy()[:, -1]
    assert min(np.abs(end[a] - end[b]).max()
               for a, b in ((0, 1), (0, 2), (1, 2))) > 5e-3


def test_batched_frontend_matches_loam_tpu(straight):
    """batched_frontend against loam_tpu's (jitted): masks and ring ids
    identical, coordinates as test_torch_frontend holds them (less_flat's
    voxel centroids within 1e-5 m, the rest exact) but for near-tie
    re-picks: the jitted reference's curvature differs from its own
    op-by-op curvature in the last bit (XLA:CPU contracts the sums of
    squares), and in scenario 1, frame 0 that flips one flat pick of
    ring 15.  The port's curvature equals the op-by-op one bit for
    bit."""
    cfg, raw, msk, _, jfeats = straight
    tcfg = to_port_cfg(cfg)
    tfeats = TR.batched_frontend(raw, msk, tcfg, device="cpu")
    repicked = []
    for name in ("sharp", "less_sharp", "flat", "less_flat", "full"):
        a, b = getattr(jfeats, name), getattr(tfeats, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_array_equal(b.ring().numpy(),
                                      np.trunc(np.asarray(a.rel)))
        tol = 1e-5 if name == "less_flat" else 0.0
        off = ((np.abs(b.xyz.numpy() - np.asarray(a.xyz)) > tol).any(-1)
               | (np.abs(b.rel.numpy() - np.asarray(a.rel)) > tol))
        repicked += [(name,) + tuple(i) for i in np.argwhere(off)]
    assert len(repicked) <= 2, repicked

    sweeps = TF.ingest_sweep(torch.tensor(raw).flatten(0, 1),
                             torch.tensor(msk).flatten(0, 1), tcfg)
    xyz = sweeps.xyz.flatten(0, 1)
    n = sweeps.mask.flatten(0, 1).sum(-1)
    with jax.disable_jit():
        jcurv = jax.vmap(lambda x, k: JFT.ring_curvature(x, k)[0])(
            jnp.asarray(xyz.numpy()), jnp.asarray(n.numpy()))
    np.testing.assert_array_equal(
        TFT.ring_curvature(xyz, n)[0].numpy(), np.asarray(jcurv))


SOLVE = 3    # the first mapping frame that solves (frame 1's map is empty)


def test_cadenced_core_matches_loam_tpu(straight):
    """The (B, F) static-cadence core on loam_tpu's features, from the JAX
    package's batched initial state carried over by
    state.pipeline_state_from_numpy, against jax.vmap of
    loam_tpu.pipeline.replay_features_cadenced: frames 0 to 2 (cadence,
    odometry, and a mapping frame on an empty map) at rot 1e-4 / trans
    1e-3.  The first solving mapping frame is held teacher-forced, as
    test_torch_imu holds its replay: from loam_tpu's state before it and
    its odometry of that frame, the port's batched mapping_step against
    loam_tpu's mapping_step run op by op for each scenario, within
    1e-6 rad / 1e-5 m (a whole replay through it amplifies rounding: the
    jitted reference differs from itself across its own entry points
    there).  The static cadence also replays the publish-flag core of
    the same features exactly."""
    cfg, _, _, _, jfeats = straight
    tcfg = to_port_cfg(cfg)
    jstate0 = JR.batched_initial_state(3, cfg)
    tstate0 = pipeline_state_from_numpy(tree_to_numpy(jstate0), device="cpu")
    ref = TR.batched_initial_state(3, tcfg, device="cpu")
    for got, want in zip(jax.tree_util.tree_leaves(tree_to_numpy(tstate0)),
                         jax.tree_util.tree_leaves(tree_to_numpy(ref))):
        np.testing.assert_array_equal(got, want)

    head = jax.tree_util.tree_map(lambda a: a[:, :SOLVE], jfeats)
    jc, _ = jax.jit(jax.vmap(
        lambda f, s: JP.replay_features_cadenced(f, cfg, s)))(head, jstate0)
    tc, tstate = TP.replay_features_cadenced(feats_to_torch(head), tcfg,
                                             state0=tstate0, device="cpu")
    _assert_close_to_jax(tc, jc)
    touts, _ = TP.replay_batch(feats_to_torch(head), tcfg, ref)
    for name in POSES + ("mapped",):
        assert torch.equal(getattr(tc, name), getattr(touts, name)), name

    assert tstate.odom.transform.shape == (3, 6)
    assert int(tc.mapped.sum()) == 3 and not tstate.map.nan_skips.any()


def test_batched_entry_points_default_to_the_card():
    """Like every entry point of the port, the batched ones run on the
    card unless asked for the CPU, and raise where there is none; a
    batch whose scenarios disagree on the mapping cadence is refused."""
    cfg = to_port_cfg(parity_cfg())
    raw = np.zeros((2, 1, 64, 3), np.float32)
    msk = np.zeros((2, 1, 64), bool)
    if not torch.cuda.is_available():
        for call in (lambda: TR.batched_replay(raw, msk, cfg),
                     lambda: TR.batched_frontend(raw, msk, cfg),
                     lambda: TR.batched_initial_state(2, cfg)):
            with pytest.raises(RuntimeError, match="device"):
                call()
    state = TR.batched_initial_state(2, cfg, device="cpu")
    state.odom.initialized[:] = True
    state.odom.frame_count[0] = 0
    feats = TR.batched_frontend(raw, msk, cfg, device="cpu")
    with pytest.raises(ValueError, match="cadence"):
        TP.pipeline_step(state, feats.map(lambda t: t[:, 0]), cfg)
