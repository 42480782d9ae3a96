"""loam_tpu_torch map store and mapping against loam_tpu from the same
mid-run state, carried across by loam_tpu_torch.state (CPU, plain
kernel versions).

Hash buckets, voxel keys and local-map membership are integers and must
be identical.  Maps are compared as sets of (key, centroid): a torch
scatter with duplicate indices may pick another claimant for a slot
than XLA's, so slot order is not part of the contract.  Centroids
agree within 1e-4 m: each frame's voxel sums are differences of prefix
sums over the whole stack (up to 8192 points x 0.4 m), which XLA and
torch associate differently.  Pose tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, map_store as JM, mapping as JMap
from loam_tpu import odometry as JO, pipeline as JP
from loam_tpu.ops.features import extract_features as j_extract

from loam_tpu_torch import map_store as TM, mapping as TMap
from loam_tpu_torch.state import (pipeline_state_from_numpy,
                                  pipeline_state_to_numpy)
from loam_tpu_torch.types import PointCloud

from torch_parity import (REFUSED, REFUSED_IDS, WIDE_K,
                          assert_same_map as _assert_same_map,
                          cloud_to_torch, make_sweeps, parity_cfg,
                          pose_errors, to_port_cfg, tree_to_numpy)

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def mid_run():
    """JAX pipeline state after frames 0-2 (one mapping frame done) and
    the odometry output of frame 3, the next mapping frame."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(4, seed=7)
    _, st = JP.replay_sweeps(jnp.asarray(raw[:3]), jnp.asarray(msk[:3]), cfg,
                             return_state=True)
    feats = j_extract(JF.ingest_sweep(jnp.asarray(raw[3]),
                                      jnp.asarray(msk[3]), cfg), cfg)
    _, odom_out = JO.odometry_step(st.odom, feats, None, cfg)
    assert bool(odom_out.publish_to_mapping)
    return cfg, st, odom_out


def test_state_roundtrip(mid_run):
    _, st, _ = mid_run
    tree = tree_to_numpy(st)
    back = pipeline_state_to_numpy(pipeline_state_from_numpy(tree,
                                                             device="cpu"))
    flat_a = jax.tree_util.tree_leaves(tree)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_hash_aggregate_insert_match():
    """_hash_u32's uint32 wraparound, per-frame voxel aggregates and a
    fresh insert agree with the JAX map store."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        TM._hash_u32(_t(a.astype(np.int64)), _t(b.astype(np.int64))).numpy(),
        np.asarray(JM._hash_u32(jnp.asarray(a), jnp.asarray(b))).astype(
            np.int64))
    xyz = rng.uniform(-20, 20, (2048, 3)).astype(np.float32)
    mask = rng.uniform(size=2048) < 0.8
    cfg = parity_cfg()
    ja = JM.aggregate_by_voxel(jnp.asarray(xyz), jnp.asarray(mask), 0.4, 2048)
    ta = TM.aggregate_by_voxel(_t(xyz), _t(mask), 0.4, 2048)
    for x, y in zip(ja[:2], ta[:2]):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x).astype(
            np.int64))
    np.testing.assert_array_equal(ta[3].numpy(), np.asarray(ja[3]))
    np.testing.assert_allclose(ta[2].numpy(), np.asarray(ja[2]), atol=1e-4)
    jt = JM.table_insert(JM.VoxelTable.create(cfg.surf_table_size), *ja, cfg)
    tt = TM.table_insert(TM.VoxelTable.create(cfg.surf_table_size,
                                              device="cpu"),
                         *ta, to_port_cfg(cfg))
    # 1616 voxels into 8192 slots: a bucket whose ways fill up within the
    # insert rounds drops its late claimants, in both packages alike
    n_voxels = int(np.asarray(ja[4]).sum())
    n_live = _assert_same_map(jt, tt)
    assert n_live == int(jt.n_live()) == int(tt.n_live())
    assert n_voxels - 4 <= n_live <= n_voxels


def test_local_map_matches(mid_run):
    """Eviction, FOV culling and the sorted local map: same membership,
    count and sort axis, same points in the same order."""
    cfg, st, odom_out = mid_run
    tobe = np.asarray(odom_out.pose)
    jc = JM.local_cube_fov(jnp.floor((jnp.asarray(tobe[3:]) + 25.0) / 50.0
                                     ).astype(jnp.int32), jnp.asarray(tobe),
                           cfg)
    center = TM.center_cube(_t(tobe))
    tcfg = to_port_cfg(cfg)
    tc = TM.local_cube_fov(center, _t(tobe), tcfg)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    jl = JM.local_map_points(st.map.surf_map, jnp.asarray(center.numpy(),
                                                          jnp.int32),
                             jc, cfg.max_surf_from_map, cfg)
    tl = TM.local_map_points(tstate.map.surf_map, center, tc,
                             cfg.max_surf_from_map, tcfg)
    assert int(tl.n_local) == int(jl.n_local) > 100
    assert int(tl.sort_axis) == int(jl.sort_axis)
    np.testing.assert_array_equal(tl.mask.numpy(), np.asarray(jl.mask))
    np.testing.assert_array_equal(tl.xyz.numpy(), np.asarray(jl.xyz))


def _teacher_forced_step(mid_run, **over):
    """One mapping frame of each package from the same state at the
    fixture's configuration with `over` changed: loam_tpu's mapping_step
    op by op, the port's on the CPU.  Returns (jstate, jout, tstate,
    tout)."""
    import dataclasses

    cfg, st, odom_out = mid_run
    cfg = dataclasses.replace(cfg, **over)
    with jax.disable_jit():
        jstate, jout = JMap.mapping_step(st.map, odom_out.pose,
                                         odom_out.corner_last,
                                         odom_out.surf_last, None, cfg)
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    tnew, tout = TMap.mapping_step(
        tstate.map, _t(odom_out.pose),
        cloud_to_torch(odom_out.corner_last, PointCloud),
        cloud_to_torch(odom_out.surf_last, PointCloud), to_port_cfg(cfg))
    return jstate, jout, tnew, tout


def _assert_step_matches(jstate, jout, tnew, tout):
    """The mapping tolerances: refined pose within 1e-5 m / 1e-6 rad,
    maps equal as sets, the same overflow and NaN-skip counts."""
    assert bool(tout.solved) and bool(jout.solved)
    rot, trans = pose_errors(tout.pose_aft.numpy(), jout.pose_aft)
    assert rot < 1e-6 and trans < 1e-5, (rot, trans)
    assert _assert_same_map(jstate.corner_map, tnew.corner_map) > 100
    assert _assert_same_map(jstate.surf_map, tnew.surf_map) > 100
    assert int(tnew.local_map_overflow) == int(jstate.local_map_overflow)
    assert int(tnew.nan_skips) == int(jstate.nan_skips)


def test_mapping_step_matches(mid_run):
    """One whole mapping frame from identical state against the JAX
    mapping_step run op by op: refined pose within 1e-5 m / 1e-6 rad,
    maps equal as sets.  The port reproduces the JAX ops one for one;
    only sums over rows (6x6 normal equations, voxel prefix sums) are
    grouped differently.  Jitted, XLA fuses the Gauss-Newton body and
    rounds differently again (~2e-4 m on this frame, which is what the
    5-frame replay test in test_torch_pipeline.py allows for)."""
    jstate, jout, tnew, tout = _teacher_forced_step(mid_run)
    _assert_step_matches(jstate, jout, tnew, tout)
    # the solve moved the pose off the prior
    prior = np.asarray(mid_run[2].pose)
    assert np.abs(np.asarray(jout.pose_aft) - prior).max() > 1e-4


def test_surround_cloud_and_unported_modes(mid_run):
    """The surround cloud keeps the JAX membership; a hybrid cache of 16
    (a gather the kNN kernel once refused) steps as loam_tpu's does."""
    cfg, st, _ = mid_run
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    cloud = TMap.surround_cloud(tstate.map, cap=4096)
    jcloud = JMap.surround_cloud(st.map, cap=4096)
    np.testing.assert_array_equal(cloud.mask.numpy(), np.asarray(jcloud.mask))
    _assert_step_matches(*_teacher_forced_step(
        mid_run, map_exact_regather_every=5, map_exact_cache_k=16))


@pytest.mark.parametrize("over", [over for _, over in WIDE_K],
                         ids=[name for name, _ in WIDE_K])
def test_mapping_step_matches_at_former_refusals(mid_run, over):
    """The k and C the neighbour kernels once lacked (an exact k outside
    1, 5 and 8, a cell gather past k = 32 or C = 1024) now run: a
    teacher-forced mapping step at each equals loam_tpu's within the
    mapping tolerances."""
    _assert_step_matches(*_teacher_forced_step(mid_run, **over))


@pytest.mark.parametrize("over,match", [case[1:] for case in REFUSED],
                         ids=REFUSED_IDS)
def test_config_refuses_k_the_kernels_lack(monkeypatch, over, match):
    """A cell-path re-rank at k > C (loam_tpu's lax.top_k refuses it too),
    or a size past a kernel's stated limit, is refused before any frame
    is processed, by the replay and by the streaming engine, on the CPU
    as on the card (test_torch_cuda.py), with a ValueError that names the
    limit."""
    import dataclasses

    from loam_tpu_torch import pipeline as TP
    from loam_tpu_torch.runtime.streaming import StreamingEngine

    def no_work(*args, **kw):
        raise AssertionError("a frame was processed")

    monkeypatch.setattr(TP, "ingest_frames", no_work)
    cfg = dataclasses.replace(to_port_cfg(parity_cfg()), **over)
    raw = np.zeros((1, cfg.max_points, 3), np.float32)
    with pytest.raises(ValueError, match=match):
        TP.replay_sweeps(raw, np.ones(raw.shape[:2], bool), cfg,
                         device="cpu")
    with pytest.raises(ValueError, match=match):
        StreamingEngine(cfg, device="cpu")
