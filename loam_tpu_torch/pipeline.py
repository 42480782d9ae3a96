"""Full-pipeline replay (counterpart of loam_tpu/pipeline.py).

The frontend (ingest + feature extraction) runs batched over all frames
at once; the recurrent odometry -> mapping -> integration core runs as a
Python loop over frames, the JAX lax.scan.  The mapping cadence
(every skipFrameNum+1-th frame, src/laserOdometry.cpp:51) is read from
the odometry's publish flag once per frame.
"""

from __future__ import annotations

import dataclasses

import torch

from loam_tpu.config import LoamConfig

from . import configure_numerics, frontend, mapping, odometry
from .ops.features import check_selection_config, extract_features
from .types import FeatureClouds
from .utils import rotations


@dataclasses.dataclass
class PipelineState:
    odom: odometry.OdomState
    map: mapping.MapState

    @staticmethod
    def create(cfg: LoamConfig, device=None) -> "PipelineState":
        return PipelineState(odom=odometry.OdomState.create(cfg, device),
                             map=mapping.MapState.create(cfg, device))


@dataclasses.dataclass
class FrameOutput:
    pose_odom: torch.Tensor        # (..., 6) /laser_odom_to_init
    pose_aft: torch.Tensor         # (..., 6) /aft_mapped_to_init
    pose_integrated: torch.Tensor  # (..., 6) /integrated_to_init
    mapped: torch.Tensor           # (...,) bool: mapping ran this frame


def mapping_frame(k: int, cfg: LoamConfig) -> bool:
    """Whether mapping runs at (0-based) frame k."""
    return k >= 1 and (k - 1) % (cfg.skip_frame_num + 1) == 0


def check_config(cfg: LoamConfig) -> None:
    """Refuse configurations outside the ported slice (never a silent
    fallback to another path)."""
    check_selection_config(cfg)
    mapping.check_mapping_config(cfg)
    if cfg.emit_registered:
        raise NotImplementedError(
            "emit_registered (the registered-cloud export) is not ported "
            "yet (ROADMAP.md, queue 1 item 9: cli.py)")


def pipeline_step(state: PipelineState, feats: FeatureClouds,
                  cfg: LoamConfig, do_mapping: bool | None = None):
    """One frame: odometry -> (on the cadence) mapping -> integration
    (transformMaintenance, src/transformMaintenance.cpp:147-180).
    do_mapping: None follows the odometry's publish flag; True/False is
    the caller's static cadence (see mapping_frame)."""
    odom_state, odom_out = odometry.odometry_step(state.odom, feats, cfg)
    if do_mapping is None:
        do_mapping = bool(odom_out.publish_to_mapping)
    map_state = state.map
    if do_mapping:
        map_state, _ = mapping.mapping_step(
            state.map, odom_out.pose, odom_out.corner_last,
            odom_out.surf_last, cfg)
    integrated = rotations.transform_associate_to_map(
        odom_out.pose, map_state.transform_bef, map_state.transform_aft)
    out = FrameOutput(
        pose_odom=odom_out.pose, pose_aft=map_state.transform_aft,
        pose_integrated=integrated, mapped=odom_out.publish_to_mapping,
    )
    return PipelineState(odom=odom_state, map=map_state), out


def _stack(outs):
    return FrameOutput(**{
        f.name: torch.stack([getattr(o, f.name) for o in outs])
        for f in dataclasses.fields(FrameOutput)
    })


def replay_sweeps(raw_xyz, raw_mask, cfg: LoamConfig = LoamConfig(),
                  imu_streams=None, t_scans=None, *,
                  state0: PipelineState | None = None,
                  return_state: bool = False):
    """Sequential replay of raw sweeps raw_xyz (F, N, 3), raw_mask (F, N)
    on their device.  Returns FrameOutput with a leading F axis (and the
    final PipelineState with return_state=True)."""
    if imu_streams is not None or t_scans is not None:
        raise NotImplementedError(
            "IMU streams are not ported yet (ROADMAP.md, queue 1 item 8)")
    check_config(cfg)
    configure_numerics()
    sweeps = frontend.ingest_sweep(raw_xyz, raw_mask, cfg)
    feats = extract_features(sweeps, cfg)
    state = state0 if state0 is not None else \
        PipelineState.create(cfg, raw_xyz.device)
    outs = []
    for k in range(raw_xyz.shape[0]):
        state, out = pipeline_step(state, feats.map(lambda t: t[k]), cfg)
        outs.append(out)
    outs = _stack(outs)
    return (outs, state) if return_state else outs


def replay_features_cadenced(feats: FeatureClouds,
                             cfg: LoamConfig = LoamConfig(),
                             state0: PipelineState | None = None):
    """Replay pre-extracted features (leading F axis, F = 1 + n *
    (skip_frame_num + 1)) with the mapping cadence resolved statically
    from the frame index.  Returns (FrameOutput, final PipelineState)."""
    F = feats.sharp.mask.shape[0]
    period = cfg.skip_frame_num + 1
    if (F - 1) % period:
        raise ValueError(f"F={F} must be 1 + n*{period} for the static "
                         "cadence")
    check_config(cfg)
    configure_numerics()
    state = state0 if state0 is not None else \
        PipelineState.create(cfg, feats.sharp.xyz.device)
    outs = []
    for k in range(F):
        state, out = pipeline_step(state, feats.map(lambda t: t[k]), cfg,
                                   do_mapping=mapping_frame(k, cfg))
        outs.append(out)
    return _stack(outs), state
