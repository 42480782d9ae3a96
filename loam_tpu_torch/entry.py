"""The one-frame forward entry and the multi-rank dry run (counterpart of
the repo's __graft_entry__.py, kept in the package).

``entry()`` gives one full pipeline frame (ingest, features, odometry,
mapping on the cadence, integration) as a function with example
arguments.  ``dryrun_multichip(n)`` runs one batched step over an n-rank
(dp, tp) mesh inside an initialized world (parallel/distributed.py).

    python -m loam_tpu_torch.entry

runs both on the card in one process (a mesh of one rank).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import configure_numerics, frontend, pipeline, resolve_device
from .config import LoamConfig
from .ops.features import extract_features


def tiny_cfg() -> LoamConfig:
    """The tiny configuration: rings of 256, small tables and local-map
    caps, 5 odometry and 3 mapping iterations."""
    return dataclasses.replace(
        LoamConfig(),
        ring_width=256,
        max_less_flat=1024,
        less_flat_ring_cap=64,
        corner_table_size=1 << 12,
        surf_table_size=1 << 13,
        search_buckets=1 << 10,
        max_corner_from_map=1024,
        max_surf_from_map=2048,
        max_corner_stack=512,
        max_surf_stack=1024,
        odom_max_iters=5,
        map_max_iters=3,
    )


def bench_cfg() -> LoamConfig:
    """bench.py's configuration: full density (ring width 2048), tables
    2^14 / 2^15, search buckets 2^12, local-map caps 8192 / 16384, the
    hybrid cadence (map_exact_regather_every=5) without the drift
    re-gather."""
    return dataclasses.replace(
        LoamConfig(), corner_table_size=1 << 14, surf_table_size=1 << 15,
        search_buckets=1 << 12, max_corner_from_map=8192,
        max_surf_from_map=16384, map_exact_knn=True,
        map_exact_regather_every=5, knn_regather_drift=0.0)


def example_inputs(cfg: LoamConfig, batch: int | None = None,
                   frames: int = 2, seed: int = 0):
    """Synthetic raw sweeps of 220 azimuths along a straight 1 m/s path,
    cut or padded to cfg.max_points: NumPy (B?, F, N, 3) float32 and
    (B?, F, N) bool, a batch repeating one scenario."""
    from .io import synth

    world = synth.make_world(seed=seed)
    poses = synth.straight_trajectory(frames, speed=1.0)
    poses = np.vstack([poses[:1], poses])[: frames + 1]
    xs, ms = [], []
    for k in range(frames):
        xyz, m = synth.simulate_sweep(
            world, poses[k], poses[k + 1], n_azimuth=220, seed=seed + k
        )
        n = cfg.max_points
        xyz, m = xyz[:n], m[:n]
        pad = n - xyz.shape[0]
        if pad > 0:
            xyz = np.pad(xyz, ((0, pad), (0, 0)))
            m = np.pad(m, (0, pad))
        xs.append(xyz)
        ms.append(m)
    raw = np.stack(xs).astype(np.float32)
    msk = np.stack(ms)
    if batch is not None:
        raw = np.broadcast_to(raw, (batch,) + raw.shape).copy()
        msk = np.broadcast_to(msk, (batch,) + msk.shape).copy()
    return raw, msk


def entry(device=None, cfg: LoamConfig | None = None):
    """(forward, example_args): forward(raw_xyz (N, 3), raw_mask (N,),
    state) runs one sweep through ingest, feature extraction and
    pipeline_step (mapping on the odometry's publish flags) and returns
    (new_state, pose_integrated (6,)).  cfg None is tiny_cfg(); device
    None is the CUDA device, and raises without one.  example_args is
    the first sweep of example_inputs and a fresh PipelineState, on
    the device."""
    cfg = tiny_cfg() if cfg is None else cfg
    device = resolve_device(device)
    pipeline.check_config(cfg)

    def forward(raw_xyz, raw_mask, state):
        configure_numerics()
        sweep = frontend.ingest_sweep(raw_xyz, raw_mask, cfg)
        feats = extract_features(sweep, cfg)
        new_state, out = pipeline.pipeline_step(state, feats, cfg, None)
        return new_state, out.pose_integrated

    raw, msk = example_inputs(cfg, frames=1)
    example_args = (torch.tensor(raw[0], device=device),
                    torch.tensor(msk[0], device=device),
                    pipeline.PipelineState.create(cfg, device))
    return forward, example_args


def dryrun_multichip(n_devices: int, cfg: LoamConfig | None = None,
                     device=None):
    """One batched step over an n_devices-rank (dp, tp) mesh: tp = 2 when
    n_devices is even, else 1; one scenario a dp block (frame 0 of
    example_inputs), run by make_sharded_step with the rows split over
    the tp group.  Every rank of the world calls it.  cfg None runs
    tiny_cfg() and then bench_cfg() (the shipped shapes).  Returns this
    rank's FrameOutput of each configuration's step."""
    from .parallel import replay as preplay

    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    outs = []
    for c in [cfg] if cfg is not None else [tiny_cfg(), bench_cfg()]:
        mesh = preplay.make_mesh(n_devices, tp=tp, devices=device)
        raw, msk = example_inputs(c, batch=dp, frames=2)
        mine = slice(mesh.dp_rank, mesh.dp_rank + 1)
        feats = preplay.batched_frontend(raw[mine], msk[mine], c,
                                         mesh.device)
        f0 = feats.map(lambda t: t[:, 0])
        state = preplay.batched_initial_state(1, c, mesh.device)
        _, out = preplay.make_sharded_step(mesh, c)(state, f0)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        outs.append(out)
    return outs


if __name__ == "__main__":
    fn, args = entry()
    _, pose = fn(*args)
    torch.cuda.synchronize()
    print("entry OK", pose.cpu().numpy())
    dryrun_multichip(1)
    print("dryrun_multichip OK")
