"""Full-pipeline replay (counterpart of loam_tpu/pipeline.py).

The frontend (ingest + feature extraction) runs batched over all frames
at once; the recurrent odometry -> mapping -> integration core runs as a
Python loop over frames, the JAX lax.scan, for a batch of B scenarios in
lockstep (the vmap of parallel/replay.py).  One scenario is the B=1 case
of that batch: replay_sweeps and pipeline_step on an unbatched state add
the scenario axis and take it off again.  The mapping cadence (every
skipFrameNum+1-th frame, src/laserOdometry.cpp:51) is read from the
odometry's publish flags once per frame, or given statically.
"""

from __future__ import annotations

import dataclasses

import torch

from . import (configure_numerics, frontend, imu as imu_mod, mapping,
               odometry, resolve_device)
from .config import LoamConfig
from .ops.features import check_selection_config, extract_features
from .types import (FeatureClouds, ImuTrans, add_scenario_axis,
                    drop_scenario_axis, tree_map)
from .utils import rotations


@dataclasses.dataclass
class PipelineState:
    odom: odometry.OdomState
    map: mapping.MapState

    @staticmethod
    def create(cfg: LoamConfig, device=None,
               batch: int | None = None) -> "PipelineState":
        """device: None is the CUDA device (raises without one); batch:
        None for one scenario, B for a leading scenario axis."""
        device = resolve_device(device)
        return PipelineState(
            odom=odometry.OdomState.create(cfg, device, batch),
            map=mapping.MapState.create(cfg, device, batch))


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
                  cfg: LoamConfig, do_mapping: bool | None = None,
                  imu: ImuTrans | None = None, map_rpy=None):
    """One frame: odometry -> (on the cadence) mapping -> integration
    (transformMaintenance, src/transformMaintenance.cpp:147-180), for
    one scenario or, when the state and features carry a leading B axis,
    for B scenarios in lockstep.
    do_mapping: None follows the odometry's publish flags (read once;
    lockstep scenarios share the cadence, and a batch whose flags differ
    raises ValueError); True/False is the caller's static cadence (see
    mapping_frame).  imu: the sweep's ImuTrans for the odometry priors;
    map_rpy: (3,) [pitch, roll, ok] at the sweep end for the mapping
    blend (None: no IMU); each with the state's leading axes."""
    if state.odom.transform.dim() == 1:
        one = add_scenario_axis
        return drop_scenario_axis(_step(
            one(state), one(feats), cfg, do_mapping, one(imu),
            None if map_rpy is None else map_rpy[None]))
    return _step(state, feats, cfg, do_mapping, imu, map_rpy)


def _step(state, feats, cfg, do_mapping, imu, map_rpy):
    odom_state, odom_out = odometry.odometry_step(state.odom, feats, cfg,
                                                  imu=imu)
    if do_mapping is None:
        publish = odom_out.publish_to_mapping
        n = int(publish.sum())
        if 0 < n < publish.shape[0]:
            raise ValueError(
                f"{n} of {publish.shape[0]} scenarios publish to mapping "
                "at this frame: a batch must share the mapping cadence")
        do_mapping = n > 0
    map_state = state.map
    if do_mapping:
        map_state, _ = mapping.mapping_step(
            state.map, odom_out.pose, odom_out.corner_last,
            odom_out.surf_last, cfg, imu_rpy=map_rpy)
    integrated = rotations.transform_associate_to_map(
        odom_out.pose, map_state.transform_bef, map_state.transform_aft)
    out = FrameOutput(
        pose_odom=odom_out.pose, pose_aft=map_state.transform_aft,
        pose_integrated=integrated, mapped=odom_out.publish_to_mapping,
    )
    return PipelineState(odom=odom_state, map=map_state), out


def _stack(outs):
    """Per-frame outputs (B, ...) as one FrameOutput (B, F, ...)."""
    return FrameOutput(**{
        f.name: torch.stack([getattr(o, f.name) for o in outs], 1)
        for f in dataclasses.fields(FrameOutput)
    })


def replay_batch(feats: FeatureClouds, cfg: LoamConfig,
                 state: PipelineState, imu_trans: ImuTrans | None = None,
                 map_rpy=None, static_cadence: bool = False):
    """The recurrent core over features with leading (B, F) axes from a
    batched state: one pipeline_step a frame for the whole batch.  The
    cadence follows the publish flags, or with static_cadence the frame
    index (mapping_frame).  imu_trans (B, F, 3) fields and map_rpy
    (B, F, 3) go with each frame.  Returns (FrameOutput (B, F, ...),
    final PipelineState)."""
    outs = []
    for k in range(feats.sharp.mask.shape[1]):
        at = lambda t: t[:, k]
        state, out = _step(
            state, feats.map(at), cfg,
            mapping_frame(k, cfg) if static_cadence else None,
            tree_map(at, imu_trans),
            None if map_rpy is None else map_rpy[:, k])
        outs.append(out)
    return _stack(outs), state


def ingest_frames(raw_xyz, raw_mask, cfg: LoamConfig,
                  imu_streams: imu_mod.ImuStream | None = None,
                  t_scans=None):
    """The batched frontend of replay_sweeps before feature extraction:
    (Sweep, ImuTrans, map_rpy), all with a leading frame axis on the
    sweeps' device.  With IMU windows (moved there) each is integrated,
    the points are deskewed, and map_rpy (F, 3) is [pitch, roll, ok] at
    the sweep end t_scan + scanPeriod (src/laserMapping.cpp:203-225);
    without, the ImuTrans and map_rpy are None."""
    if (imu_streams is None) != (t_scans is None):
        raise ValueError("imu_streams and t_scans go together")
    if imu_streams is None:
        return frontend.ingest_sweep(raw_xyz, raw_mask, cfg), None, None
    device = raw_xyz.device
    streams = imu_streams.map(lambda a: torch.as_tensor(a).to(device))
    t_scans = torch.as_tensor(t_scans, dtype=torch.float32).to(device)
    sweeps, imu_trans = frontend.ingest_sweep_imu(
        raw_xyz, raw_mask, cfg, streams, imu_mod.integrate(streams, cfg),
        t_scans)
    rpy, ok = imu_mod.rpy_at(streams, t_scans + cfg.scan_period)
    map_rpy = torch.stack([rpy[:, 0], rpy[:, 2], ok.to(torch.float32)], -1)
    return sweeps, imu_trans, map_rpy


def replay_sweeps(raw_xyz, raw_mask, cfg: LoamConfig = LoamConfig(),
                  imu_streams: imu_mod.ImuStream | None = None,
                  t_scans=None, *, state0: PipelineState | None = None,
                  return_state: bool = False, device=None):
    """Sequential replay of raw sweeps raw_xyz (F, N, 3), raw_mask (F, N),
    NumPy arrays or tensors on any device, moved to `device`: None is
    the CUDA device (a RuntimeError without one), "cpu" asks for the
    CPU.  A state0 (one scenario) must already live there.  The
    recurrent core runs as the B=1 case of replay_batch.

    imu_streams: an ImuStream with a leading F axis (each frame's window
    of samples) and t_scans (F,) the sweep start times, moved to the same
    device.  With them each frame's window is integrated, the frontend
    deskews every point into the sweep-start IMU frame, the odometry
    takes the ImuTrans priors and the mapping blends in the IMU pitch and
    roll at t_scan + scanPeriod (src/laserMapping.cpp:203-225).

    Returns FrameOutput with a leading F axis (and the final
    PipelineState with return_state=True)."""
    check_config(cfg)
    device = resolve_device(device)
    configure_numerics()
    raw_xyz = torch.as_tensor(raw_xyz, dtype=torch.float32).to(device)
    raw_mask = torch.as_tensor(raw_mask, dtype=torch.bool).to(device)
    sweeps, imu_trans, map_rpy = ingest_frames(raw_xyz, raw_mask, cfg,
                                               imu_streams, t_scans)
    feats = extract_features(sweeps, cfg)
    state = state0 if state0 is not None else \
        PipelineState.create(cfg, device)
    one = add_scenario_axis
    outs, state = drop_scenario_axis(replay_batch(
        one(feats), cfg, one(state), one(imu_trans),
        None if map_rpy is None else map_rpy[None]))
    return (outs, state) if return_state else outs


def replay_features(feats: FeatureClouds, cfg: LoamConfig = LoamConfig(),
                    imu_trans: ImuTrans | None = None,
                    with_imu: bool = False, device=None) -> FrameOutput:
    """Replay pre-extracted features (leading F axis) through the
    recurrent core only, on `device` (None: the CUDA device), the
    cadence following the publish flag.  With with_imu and an ImuTrans
    (leading F axis) the odometry takes its priors; the mapping blend
    needs the IMU at the sweep end, which an ImuTrans does not hold, so
    it is left out, as in loam_tpu.pipeline.replay_features."""
    check_config(cfg)
    device = resolve_device(device)
    configure_numerics()
    one = lambda t: t[None].to(device)
    imu_trans = tree_map(one, imu_trans) if with_imu else None
    outs, _ = replay_batch(tree_map(one, feats), cfg,
                           PipelineState.create(cfg, device, batch=1),
                           imu_trans)
    return drop_scenario_axis(outs)


def replay_features_cadenced(feats: FeatureClouds,
                             cfg: LoamConfig = LoamConfig(),
                             state0: PipelineState | None = None,
                             device=None):
    """Replay pre-extracted features with leading (F,) or (B, F) axes,
    F = 1 + n * (skip_frame_num + 1), with the mapping cadence resolved
    statically from the frame index, on `device` (None: the CUDA device,
    as in replay_sweeps).  The (B, F) form is the core that
    loam_tpu's bench vmaps over scenarios; state0, if given, has the
    features' leading scenario axis or none.  Returns (FrameOutput,
    final PipelineState) with the features' leading axes."""
    single = feats.sharp.mask.dim() == 2
    F = feats.sharp.mask.shape[-2]
    period = cfg.skip_frame_num + 1
    if (F - 1) % period:
        raise ValueError(f"F={F} must be 1 + n*{period} for the static "
                         "cadence")
    check_config(cfg)
    device = resolve_device(device)
    configure_numerics()
    feats = feats.map(lambda t: t.to(device))
    if single:
        feats, state0 = add_scenario_axis(feats), add_scenario_axis(state0)
    state = state0 if state0 is not None else \
        PipelineState.create(cfg, device, batch=feats.sharp.mask.shape[0])
    out = replay_batch(feats, cfg, state, static_cadence=True)
    return drop_scenario_axis(out) if single else out
