"""Carry pipeline state across frameworks and devices.

LOAM has no weights: its parameters are the pipeline state (the
odometry's previous clouds and poses, the mapping's voxel tables and
pose pair).  The interchange format is a nested dict of NumPy arrays
with the JAX package's field names, so a test can start both packages
from the same mid-run state:

    {"odom": {"corner_last": {"xyz", "rel", "mask"}, "surf_last": {...},
              "transform", "transform_sum", "initialized", "frame_count",
              "nan_skips"},
     "map": {"corner_map": {"key_hi", "key_lo", "sum_xyz", "cnt"},
             "surf_map": {...}, "transform_bef", "transform_aft",
             "nan_skips", "local_map_overflow"}}

Voxel keys are uint32 in NumPy and int64 in the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .map_store import VoxelTable
from .mapping import MapState
from .odometry import OdomState
from .pipeline import PipelineState
from .types import PointCloud

_KEYS = ("key_hi", "key_lo")


def _to_tensor(name, a, device):
    a = np.asarray(a)
    if name in _KEYS:
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.copy(), device=device)


def _build(cls, tree, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = tree[f.name]
        sub = {"corner_last": PointCloud, "surf_last": PointCloud,
               "corner_map": VoxelTable, "surf_map": VoxelTable}.get(f.name)
        kw[f.name] = (_build(sub, v, device) if sub is not None
                      else _to_tensor(f.name, v, device))
    return cls(**kw)


def pipeline_state_from_numpy(tree, device=None) -> PipelineState:
    return PipelineState(odom=_build(OdomState, tree["odom"], device),
                         map=_build(MapState, tree["map"], device))


def _to_numpy(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    a = obj.detach().cpu().numpy()
    return a


def pipeline_state_to_numpy(state: PipelineState) -> dict:
    tree = _to_numpy(state)
    for table in ("corner_map", "surf_map"):
        for k in _KEYS:
            tree["map"][table][k] = tree["map"][table][k].astype(np.uint32)
    return tree
