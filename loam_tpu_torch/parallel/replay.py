"""Scenario-batched replay on one card (counterpart of the single-device
part of loam_tpu/parallel/replay.py).

The JAX package vmaps its replay over a leading scenario axis.  Here B
scenarios run in lockstep through one recurrent core: every state
tensor carries the scenario axis, each kernel launch serves the whole
batch (the kernels take it as their grid's batch axis), and each host
read of a convergence or cadence flag covers every scenario.  A
scenario that converges early, or cannot solve, is frozen by its own
mask, so each scenario's poses equal its own single-scenario replay.
"""

from __future__ import annotations

import torch

from .. import configure_numerics, frontend, resolve_device
from ..config import LoamConfig
from ..ops.features import extract_features
from ..pipeline import PipelineState, check_config, replay_batch


def batched_initial_state(batch: int, cfg: LoamConfig,
                          device=None) -> PipelineState:
    """A PipelineState with a leading scenario axis of `batch` (device:
    None is the CUDA device, and raises without one)."""
    return PipelineState.create(cfg, resolve_device(device), batch=batch)


def batched_frontend(raw_xyz, raw_mask, cfg: LoamConfig, device=None):
    """Ingest and feature extraction over (B, F) scenario-frame axes, as
    one call of the frame-batched frontend on B*F frames.  raw_xyz
    (B, F, N, 3) and raw_mask (B, F, N), NumPy arrays or tensors, are
    moved to `device` (None: the CUDA device, and raises without one).
    Returns FeatureClouds with leading (B, F) axes."""
    device = resolve_device(device)
    configure_numerics()
    raw_xyz = torch.as_tensor(raw_xyz, dtype=torch.float32).to(device)
    raw_mask = torch.as_tensor(raw_mask, dtype=torch.bool).to(device)
    lead = raw_mask.shape[:2]
    sweeps = frontend.ingest_sweep(raw_xyz.flatten(0, 1),
                                   raw_mask.flatten(0, 1), cfg)
    feats = extract_features(sweeps, cfg)
    return feats.map(lambda t: t.reshape(lead + t.shape[1:]))


def batched_replay(raw_xyz, raw_mask, cfg: LoamConfig = LoamConfig(),
                   device=None):
    """The full pipeline over B scenarios of F sweeps each: raw_xyz
    (B, F, N, 3), raw_mask (B, F, N), NumPy arrays or tensors, on
    `device` (None: the CUDA device, and raises without one).  The
    mapping cadence follows the publish flags, shared by the lockstep
    scenarios.  Returns FrameOutput with leading (B, F) axes."""
    check_config(cfg)
    device = resolve_device(device)
    feats = batched_frontend(raw_xyz, raw_mask, cfg, device)
    B = feats.sharp.mask.shape[0]
    outs, _ = replay_batch(feats, cfg, batched_initial_state(B, cfg, device))
    return outs
