"""loam_tpu_torch's cached-candidate mapping modes against loam_tpu (CPU,
plain kernel versions): the hybrid cadence (map_exact_regather_every > 1)
and the cell-bucket map (map_exact_knn=False).

Bucket hashes, grid membership and candidate sets are integer decisions
or copies of map centroids and must be equal.  Single mapping frames are
held against the JAX mapping_step run op by op (jax.disable_jit) at
1e-5 m / 1e-6 rad, as tests/test_torch_mapping.py holds the strict mode;
five-frame replays against the jitted JAX replay at 1e-3 m / 1e-4 rad
(XLA fuses the Gauss-Newton body and rounds differently by ~1e-4 m a
mapping solve, see tests/test_torch_pipeline.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import config as JC, frontend as JF, map_store as JM
from loam_tpu import mapping as JMap, odometry as JO, pipeline as JP
from loam_tpu.io import synth as JSynth
from loam_tpu.ops.features import extract_features as j_extract

from loam_tpu_torch import config as TC, frontend as TF, map_store as TM
from loam_tpu_torch import mapping as TMap, odometry as TO, pipeline as TP
from loam_tpu_torch.io import synth as TSynth
from loam_tpu_torch.ops.features import extract_features as t_extract
from loam_tpu_torch.state import pipeline_state_from_numpy
from loam_tpu_torch.types import PointCloud

from torch_parity import (assert_same_map, cloud_to_torch, make_sweeps,
                          parity_cfg, pose_errors, to_port_cfg,
                          tree_to_numpy)

torch.set_num_threads(1)

# single-frame cases: 5 iterations in rounds of 2, so the loop runs up to
# three rounds and the last round's second iteration is masked by the cap
MODES = {
    "hybrid": dict(map_exact_regather_every=2, map_max_iters=5),
    "cells": dict(map_exact_knn=False, map_regather_every=2,
                  map_max_iters=5),
}
# replay cases: the two switches as users set them
REPLAY_MODES = {
    "hybrid": dict(map_exact_regather_every=5),
    "cells": dict(map_exact_knn=False),
}


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def mid_run():
    """JAX pipeline state after frames 0-2 and the odometry output of
    frame 3, the next mapping frame.  The only mapping frame so far met
    an empty map (insert, no solve), so this state is the same in every
    mapping mode."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(4, seed=7)
    _, st = JP.replay_sweeps(jnp.asarray(raw[:3]), jnp.asarray(msk[:3]), cfg,
                             return_state=True)
    feats = j_extract(JF.ingest_sweep(jnp.asarray(raw[3]),
                                      jnp.asarray(msk[3]), cfg), cfg)
    _, odom_out = JO.odometry_step(st.odom, feats, None, cfg)
    assert bool(odom_out.publish_to_mapping)
    return cfg, st, odom_out


def test_config_and_synth_are_faithful_copies():
    """The port's own LoamConfig has the JAX package's fields, order and
    defaults, and its synth module makes the same arrays from a seed."""
    jf, tf = dataclasses.fields(JC.LoamConfig), dataclasses.fields(
        TC.LoamConfig)
    assert [(f.name, f.type, f.default) for f in tf] == \
        [(f.name, f.type, f.default) for f in jf]
    assert dataclasses.asdict(TC.LoamConfig()) == \
        dataclasses.asdict(JC.LoamConfig())
    assert TC.LoamConfig().max_points == JC.LoamConfig().max_points
    assert to_port_cfg(parity_cfg()).search_buckets == 1 << 10
    hash(TC.LoamConfig())      # frozen, usable as a cache key
    wa, wb = JSynth.make_world(seed=9), TSynth.make_world(seed=9)
    for f in dataclasses.fields(wa):
        np.testing.assert_array_equal(getattr(wa, f.name),
                                      getattr(wb, f.name))
    pa = JSynth.straight_trajectory(3, speed=0.9, yaw_rate=0.1)
    pb = TSynth.straight_trajectory(3, speed=0.9, yaw_rate=0.1)
    np.testing.assert_array_equal(pa, pb)
    xa, ma = JSynth.simulate_sweep(wa, pa[0], pa[1], n_azimuth=120, seed=2)
    xb, mb = TSynth.simulate_sweep(wb, pb[0], pb[1], n_azimuth=120, seed=2)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ma, mb)
    assert ma.sum() > 1000


def test_cell_bucket_matches_on_signed_cells():
    """int32 wrap-around of negative cells times the primes, reproduced
    in int64 halves."""
    rng = np.random.default_rng(0)
    cells = rng.integers(-300, 301, size=(4096, 27, 3)).astype(np.int32)
    cells[0, 0] = (-300, 300, -1)
    cells[0, 1] = (0, 0, 0)
    for n_buckets in (1 << 10, 1 << 14, 1000):
        jb = np.asarray(JM._cell_bucket(jnp.asarray(cells), n_buckets))
        tb = TM._cell_bucket(_t(cells.astype(np.int64)), n_buckets).numpy()
        np.testing.assert_array_equal(tb, jb.astype(np.int64))
        assert tb.min() >= 0 and tb.max() < n_buckets


@pytest.mark.parametrize("search_cell,chunk", [(1.0, 2048), (0.7, 128)])
def test_search_grid_and_candidates_match(mid_run, search_cell, chunk):
    """build_search_grid, knn_candidates (one chunk, then four) and
    knn_from_candidates from the same carried-across table; 0.7 m cells
    make floor(x / cell) depend on true division."""
    cfg, st, odom_out = mid_run
    cfg = dataclasses.replace(cfg, search_cell=search_cell,
                              knn_query_chunk=chunk)
    tcfg = to_port_cfg(cfg)
    tobe = np.asarray(odom_out.pose)
    jcenter = jnp.floor((jnp.asarray(tobe[3:]) + 25.0) / 50.0).astype(
        jnp.int32)
    jfov = JM.local_cube_fov(jcenter, jnp.asarray(tobe), cfg)
    jg = JM.build_search_grid(st.map.surf_map, jcenter, jfov, cfg)
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    center = TM.center_cube(_t(tobe))
    tg = TM.build_search_grid(tstate.map.surf_map, center,
                              TM.local_cube_fov(center, _t(tobe), tcfg), tcfg)
    assert int(tg.n_local) == int(jg.n_local) > 100
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    np.testing.assert_array_equal(tg.xyz.numpy(), np.asarray(jg.xyz))
    # some bucket is full or shared at 2^10 buckets, some slots are free
    assert 0 < int(tg.valid.sum()) <= int(tg.n_local)

    rng = np.random.default_rng(1)
    cent = np.asarray(st.map.surf_map.centroids())[
        np.asarray(st.map.surf_map.live())]
    Q = 512
    q = (cent[rng.integers(0, len(cent), Q)]
         + rng.normal(0, 0.3, (Q, 3))).astype(np.float32)
    q_mask = rng.uniform(size=Q) < 0.9
    k = cfg.knn_candidates
    jc, jv = JM.knn_candidates(jg, jnp.asarray(q), jnp.asarray(q_mask), k,
                               cfg)
    tc, tv = TM.knn_candidates(tg, _t(q), _t(q_mask), k, tcfg)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tc.numpy()[jv], np.asarray(jc)[jv])
    assert jv[q_mask].sum() > Q and not jv[~q_mask].any()

    q2 = q + np.float32(0.01)
    jp, jd = JM.knn_from_candidates(jc, jnp.asarray(jv), jnp.asarray(q2), 5)
    tp, td = TM.knn_from_candidates(tc, tv, _t(q2), 5)
    found = np.asarray(jd) < 1e29
    np.testing.assert_array_equal(td.numpy() < 1e29, found)
    np.testing.assert_allclose(td.numpy()[found], np.asarray(jd)[found],
                               atol=1e-6)
    np.testing.assert_array_equal(tp.numpy()[found], np.asarray(jp)[found])
    # knn_search is the two composed
    sp, sd = TM.knn_search(tg, _t(q), _t(q_mask), 5, tcfg)
    rp, rd = TM.knn_from_candidates(*TM.knn_candidates(
        tg, _t(q), _t(q_mask), 5, tcfg), _t(q), 5)
    assert torch.equal(sp, rp) and torch.equal(sd, rd)


def _mapping_pair(mid_run, mode_kw, pose=None):
    """The same mapping frame through both packages, JAX op by op."""
    cfg, st, odom_out = mid_run
    cfg = dataclasses.replace(cfg, **mode_kw)
    pose = np.asarray(odom_out.pose) if pose is None else pose
    with jax.disable_jit():
        jstate, jout = JMap.mapping_step(
            st.map, jnp.asarray(pose), odom_out.corner_last,
            odom_out.surf_last, None, cfg)
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    tnew, tout = TMap.mapping_step(
        tstate.map, _t(pose), cloud_to_torch(odom_out.corner_last, PointCloud),
        cloud_to_torch(odom_out.surf_last, PointCloud), to_port_cfg(cfg))
    return jstate, jout, tnew, tout


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mapping_step_matches(mid_run, mode):
    """One whole mapping frame in each cached-candidate mode: refined
    pose within 1e-5 m / 1e-6 rad of the op-by-op JAX run, maps equal as
    sets of (key, centroid)."""
    jstate, jout, tnew, tout = _mapping_pair(mid_run, MODES[mode])
    assert bool(tout.solved) and bool(jout.solved)
    rot, trans = pose_errors(tout.pose_aft.numpy(), jout.pose_aft)
    assert rot < 1e-6 and trans < 1e-5, (rot, trans)
    prior = np.asarray(mid_run[2].pose)
    assert np.abs(np.asarray(jout.pose_aft) - prior).max() > 1e-4
    assert assert_same_map(jstate.corner_map, tnew.corner_map) > 100
    assert assert_same_map(jstate.surf_map, tnew.surf_map) > 100
    assert int(tnew.local_map_overflow) == int(jstate.local_map_overflow)
    assert int(tnew.nan_skips) == int(jstate.nan_skips)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_perturbed_prior_regathers(mid_run, mode, monkeypatch):
    """The prior pushed 0.5 m off (tests/test_knn_stress.py): the iterate
    moves more than knn_regather_drift inside a round, the drift test
    re-gathers, and the pose stays within 1e-4 m of the JAX run (the
    perturbed solve takes larger steps than the clean one, so rounding
    differences grow with it)."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=3)
    pose = np.asarray(mid_run[2].pose) + np.concatenate(
        [np.zeros(3), d / np.linalg.norm(d) * 0.5]).astype(np.float32)
    kw = dict(MODES[mode], map_max_iters=6, **(
        dict(map_exact_regather_every=3) if mode == "hybrid"
        else dict(map_regather_every=3)))

    gathers = []
    name = "knn_points" if mode == "hybrid" else "knn_candidates"
    target = TMap if mode == "hybrid" else TM
    real = getattr(target, name)

    def counted(*a, **k):
        gathers.append(1)
        return real(*a, **k)

    monkeypatch.setattr(target, name, counted)
    _, jout, _, tout = _mapping_pair(mid_run, kw, pose)
    with_drift = len(gathers)
    rot, trans = pose_errors(tout.pose_aft.numpy(), jout.pose_aft)
    assert rot < 1e-5 and trans < 1e-4, (rot, trans)
    assert np.abs(tout.pose_aft.numpy()[3:] - pose[3:]).max() > 0.1

    # the same frame with the drift test off gathers once a round only
    del gathers[:]
    cfg, st, odom_out = mid_run
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    TMap.mapping_step(
        tstate.map, _t(pose), cloud_to_torch(odom_out.corner_last, PointCloud),
        cloud_to_torch(odom_out.surf_last, PointCloud),
        to_port_cfg(dataclasses.replace(cfg, knn_regather_drift=0.0, **kw)))
    assert 2 <= len(gathers) <= 4           # two clouds, at most two rounds
    assert with_drift > len(gathers)


@pytest.mark.parametrize("mode", sorted(REPLAY_MODES))
def test_replay_sweeps_matches_loam_tpu(mode):
    """Five frames (two mapping frames) in each mode against the jitted
    JAX replay: same cadence, poses within 1e-3 m / 1e-4 rad."""
    cfg = dataclasses.replace(parity_cfg(), **REPLAY_MODES[mode])
    raw, msk, _ = make_sweeps(5, seed=3)
    jouts = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg)
    touts = TP.replay_sweeps(raw, msk, to_port_cfg(cfg), device="cpu")
    np.testing.assert_array_equal(touts.mapped.numpy(),
                                  np.asarray(jouts.mapped))
    assert touts.mapped.numpy().sum() == 2
    for name in ("pose_odom", "pose_aft", "pose_integrated"):
        rot, trans = pose_errors(getattr(touts, name).numpy(),
                                 getattr(jouts, name))
        assert rot < 1e-4 and trans < 1e-3, (name, rot, trans)
    est = touts.pose_integrated.numpy()
    assert np.isfinite(est).all() and np.abs(est[-1, 3:6]).max() > 0.2
    # the second mapping frame solved against the first one's map
    assert np.abs(touts.pose_aft.numpy()[-1]).max() > 0


@pytest.mark.parametrize("entry", ["replay_sweeps", "replay_features_cadenced",
                                   "PipelineState", "MapState", "OdomState",
                                   "VoxelTable", "state_from_numpy"])
def test_entry_points_default_to_the_card(entry, mid_run):
    """device=None means the CUDA device: without one every entry point
    raises a RuntimeError that says so, and runs with device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cfg = to_port_cfg(mid_run[0])
    raw, msk, _ = make_sweeps(1, seed=3, n_azimuth=240)
    feats = t_extract(TF.ingest_sweep(_t(raw), _t(msk), cfg), cfg)
    tree = tree_to_numpy(mid_run[1])
    calls = {
        "replay_sweeps": lambda **kw: TP.replay_sweeps(raw, msk, cfg, **kw),
        "replay_features_cadenced":
            lambda **kw: TP.replay_features_cadenced(feats, cfg, **kw),
        "PipelineState": lambda **kw: TP.PipelineState.create(cfg, **kw),
        "MapState": lambda **kw: TMap.MapState.create(cfg, **kw),
        "OdomState": lambda **kw: TO.OdomState.create(cfg, **kw),
        "VoxelTable": lambda **kw: TM.VoxelTable.create(64, **kw),
        "state_from_numpy": lambda **kw: pipeline_state_from_numpy(tree,
                                                                   **kw),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    out = calls[entry](device="cpu")
    leaf = out
    while not isinstance(leaf, torch.Tensor):
        leaf = leaf[0] if isinstance(leaf, tuple) else getattr(
            leaf, dataclasses.fields(leaf)[0].name)
    assert leaf.device.type == "cpu"
