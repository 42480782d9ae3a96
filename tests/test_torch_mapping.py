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

from torch_parity import (cloud_to_torch, make_sweeps, parity_cfg,
                          pose_errors, tree_to_numpy)

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


def _table_set(key_hi, key_lo, centroids):
    key_hi = np.asarray(key_hi).astype(np.int64)
    live = key_hi != 0xFFFFFFFF
    keys = key_hi[live] * (1 << 32) + np.asarray(key_lo).astype(np.int64)[live]
    return dict(zip(keys.tolist(), np.asarray(centroids)[live]))


def _assert_same_map(jtable, ttable):
    a = _table_set(jtable.key_hi, jtable.key_lo, jtable.centroids())
    b = _table_set(ttable.key_hi.numpy(), ttable.key_lo.numpy(),
                   ttable.centroids().numpy())
    assert a.keys() == b.keys()
    keys = sorted(a)
    np.testing.assert_allclose(np.array([b[k] for k in keys]),
                               np.array([a[k] for k in keys]), atol=1e-4)
    return len(keys)


def test_state_roundtrip(mid_run):
    _, st, _ = mid_run
    tree = tree_to_numpy(st)
    back = pipeline_state_to_numpy(pipeline_state_from_numpy(tree))
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
    tt = TM.table_insert(TM.VoxelTable.create(cfg.surf_table_size), *ta, cfg)
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
    tc = TM.local_cube_fov(center, _t(tobe), cfg)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    tstate = pipeline_state_from_numpy(tree_to_numpy(st))
    jl = JM.local_map_points(st.map.surf_map, jnp.asarray(center.numpy(),
                                                          jnp.int32),
                             jc, cfg.max_surf_from_map, cfg)
    tl = TM.local_map_points(tstate.map.surf_map, center, tc,
                             cfg.max_surf_from_map, cfg)
    assert int(tl.n_local) == int(jl.n_local) > 100
    assert int(tl.sort_axis) == int(jl.sort_axis)
    np.testing.assert_array_equal(tl.mask.numpy(), np.asarray(jl.mask))
    np.testing.assert_array_equal(tl.xyz.numpy(), np.asarray(jl.xyz))


def test_mapping_step_matches(mid_run):
    """One whole mapping frame from identical state against the JAX
    mapping_step run op by op: refined pose within 1e-5 m / 1e-6 rad,
    maps equal as sets.  The port reproduces the JAX ops one for one;
    only sums over rows (6x6 normal equations, voxel prefix sums) are
    grouped differently.  Jitted, XLA fuses the Gauss-Newton body and
    rounds differently again (~2e-4 m on this frame, which is what the
    5-frame replay test in test_torch_pipeline.py allows for)."""
    cfg, st, odom_out = mid_run
    with jax.disable_jit():
        jstate, jout = JMap.mapping_step(st.map, odom_out.pose,
                                         odom_out.corner_last,
                                         odom_out.surf_last, None, cfg)
    tstate = pipeline_state_from_numpy(tree_to_numpy(st))
    tnew, tout = TMap.mapping_step(
        tstate.map, _t(odom_out.pose),
        cloud_to_torch(odom_out.corner_last, PointCloud),
        cloud_to_torch(odom_out.surf_last, PointCloud), cfg)
    assert bool(tout.solved) and bool(jout.solved)
    rot, trans = pose_errors(tout.pose_aft.numpy(), jout.pose_aft)
    assert rot < 1e-6 and trans < 1e-5, (rot, trans)
    # the solve moved the pose off the prior
    prior = np.asarray(odom_out.pose)
    assert np.abs(np.asarray(jout.pose_aft) - prior).max() > 1e-4
    assert _assert_same_map(jstate.corner_map, tnew.corner_map) > 100
    assert _assert_same_map(jstate.surf_map, tnew.surf_map) > 100
    assert int(tnew.local_map_overflow) == int(jstate.local_map_overflow)
    assert int(tnew.nan_skips) == int(jstate.nan_skips)


def test_surround_cloud_and_unported_modes(mid_run):
    import dataclasses

    cfg, st, _ = mid_run
    tstate = pipeline_state_from_numpy(tree_to_numpy(st))
    cloud = TMap.surround_cloud(tstate.map, cap=4096)
    jcloud = JMap.surround_cloud(st.map, cap=4096)
    np.testing.assert_array_equal(cloud.mask.numpy(), np.asarray(jcloud.mask))
    for bad in (dict(map_exact_knn=False), dict(map_exact_regather_every=5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TMap.mapping_step(tstate.map, torch.zeros(6),
                              PointCloud.zeros(cfg.max_less_sharp),
                              PointCloud.zeros(cfg.max_less_flat),
                              dataclasses.replace(cfg, **bad))
