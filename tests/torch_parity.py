"""Shared helpers for the loam_tpu_torch parity tests: one NumPy input,
both packages, outputs compared as NumPy arrays.  Importing this module
imports neither jax nor loam_tpu (parity_cfg does, when called)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from loam_tpu_torch.config import LoamConfig as PortConfig
from loam_tpu_torch.io import synth


def tree_to_numpy(obj):
    """A (JAX or torch) dataclass tree as nested dicts of NumPy arrays."""
    if dataclasses.is_dataclass(obj):
        return {f.name: tree_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def cloud_to_torch(cloud, cls):
    """A JAX PointCloud (any leading axes) as a port PointCloud."""
    return cls(xyz=torch.tensor(np.asarray(cloud.xyz)),
               rel=torch.tensor(np.asarray(cloud.rel)),
               mask=torch.tensor(np.asarray(cloud.mask)))


def feats_to_torch(feats):
    from loam_tpu_torch.types import FeatureClouds, PointCloud

    return FeatureClouds(**{
        f.name: cloud_to_torch(getattr(feats, f.name), PointCloud)
        for f in dataclasses.fields(feats)
    })


def parity_cfg(**kw):
    """The tiny test configuration (__graft_entry__._tiny_cfg, a
    loam_tpu LoamConfig) with rings wide enough for 480-azimuth sweeps:
    at the tiny 256-wide rings the sparse azimuth spacing trips the
    parallel-beam filter on every point and no feature is ever
    selected."""
    from __graft_entry__ import _tiny_cfg

    base = dict(ring_width=512, max_less_flat=2048, less_flat_ring_cap=256)
    base.update(kw)
    return dataclasses.replace(_tiny_cfg(), **base)


def to_port_cfg(jcfg) -> PortConfig:
    """The port's LoamConfig with the fields of a loam_tpu one."""
    return PortConfig(**dataclasses.asdict(jcfg))


def make_sweeps(frames: int, seed: int = 3, n_azimuth: int = 480,
                speed: float = 0.9, yaw_rate: float = 0.12):
    """Seeded synthetic VLP-16 sweeps (F, N, 3), masks (F, N), poses."""
    world = synth.make_world(seed=seed)
    poses = synth.straight_trajectory(frames, speed=speed, yaw_rate=yaw_rate)
    poses = np.vstack([poses[:1], poses])[: frames + 1]
    sweeps = [synth.simulate_sweep(world, poses[k], poses[k + 1],
                                   n_azimuth=n_azimuth, seed=seed + k)
              for k in range(frames)]
    raw = np.stack([s[0] for s in sweeps]).astype(np.float32)
    msk = np.stack([s[1] for s in sweeps])
    return raw, msk, poses


def pose_errors(a, b):
    """Max |rotation| (rad) and |translation| (m) differences of (..., 6)
    pose arrays."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d[..., :3].max()), float(d[..., 3:].max())


def _table_set(key_hi, key_lo, centroids):
    key_hi = np.asarray(key_hi).astype(np.int64)
    live = key_hi != 0xFFFFFFFF
    keys = key_hi[live] * (1 << 32) + np.asarray(key_lo).astype(np.int64)[live]
    return dict(zip(keys.tolist(), np.asarray(centroids)[live]))


def assert_same_map(jtable, ttable):
    """A JAX and a port VoxelTable hold the same keys with centroids
    within 1e-4 m (slot order is not part of the contract).  Returns the
    number of live entries."""
    a = _table_set(jtable.key_hi, jtable.key_lo, jtable.centroids())
    b = _table_set(ttable.key_hi.numpy(), ttable.key_lo.numpy(),
                   ttable.centroids().numpy())
    assert a.keys() == b.keys()
    keys = sorted(a)
    np.testing.assert_allclose(np.array([b[k] for k in keys]),
                               np.array([a[k] for k in keys]), atol=1e-4)
    return len(keys)
