"""Scenario-batched replay (counterpart of loam_tpu/parallel/replay.py):
on one card, and over a (dp, tp) mesh of ranks.

The JAX package vmaps its replay over a leading scenario axis.  Here B
scenarios run in lockstep through one recurrent core: every state
tensor carries the scenario axis, each kernel launch serves the whole
batch (the kernels take it as their grid's batch axis), and each host
read of a convergence or cadence flag covers every scenario.  A
scenario that converges early, or cannot solve, is frozen by its own
mask, so each scenario's poses equal its own single-scenario replay.

Over several ranks the port is SPMD by hand, one process a rank: the
mesh lays the ranks out dp-major, each dp block runs its own scenarios
with no collective at all (scenarios never communicate), and the ranks
of a tp group split the Jacobian rows of every normal-equation sum
(parallel/context.py), one all_reduce a Gauss-Newton iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import configure_numerics, frontend, resolve_device
from ..config import LoamConfig
from ..ops.features import extract_features
from ..pipeline import PipelineState, check_config, pipeline_step, \
    replay_batch
from .context import row_sharding


@dataclasses.dataclass
class Mesh:
    """A (dp, tp) layout of the first dp*tp ranks of the world, dp-major
    (rank = dp_rank * tp + tp_rank), as seen by one rank.  dp_group
    holds the ranks of this rank's tp column (one per dp block),
    tp_group those of its dp block; a rank outside the mesh (rank >=
    dp*tp) has dp_rank, tp_rank and both groups None.  In one process
    with no process group both groups are None."""
    dp: int
    tp: int
    rank: int
    world: int
    dp_rank: int | None
    tp_rank: int | None
    dp_group: object
    tp_group: object
    device: torch.device

    @property
    def member(self) -> bool:
        return self.dp_rank is not None


def make_mesh(n_devices: int | None = None, tp: int = 1,
              devices=None) -> Mesh:
    """A (dp, tp) mesh over the first n_devices ranks (None: every rank
    of the world).  Every rank of the world must call it, in the same
    order as its other collectives: it creates the groups with
    torch.distributed.new_group.  In one process with no process group
    it is the (1, 1) mesh.  devices: this rank's device; None is the
    current CUDA device (the one distributed.initialize set), and raises
    without one."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(
            f"a mesh of {n} ranks needs {n} processes, one a rank, and "
            f"this world has {world}: start one process per rank "
            "(distributed.initialize); the port never runs several dp "
            "blocks in one process")
    if n < 1 or tp < 1 or n % tp:
        raise ValueError(f"tp={tp} must divide the mesh's {n} ranks")
    dp = n // tp
    device = resolve_device(devices)
    if not grouped:
        return Mesh(1, 1, 0, 1, 0, 0, None, None, device)
    dp_group = tp_group = None
    # every rank creates every group, in one order
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)])
        if rank < n and rank % tp == t:
            dp_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + t for t in range(tp)])
        if rank < n and rank // tp == d:
            tp_group = g
    if rank >= n:
        return Mesh(dp, tp, rank, world, None, None, None, None, device)
    return Mesh(dp, tp, rank, world, rank // tp, rank % tp, dp_group,
                tp_group, device)


def _tp_context(mesh: Mesh):
    return row_sharding(mesh.tp_group if mesh.tp > 1 else None)


def make_sharded_replay(mesh: Mesh, cfg: LoamConfig):
    """fn(raw (B_local, F, N, 3), mask (B_local, F, N)) -> this rank's
    FrameOutput (B_local, F, ...): batched_replay of this rank's
    scenario block on mesh.device, with the Jacobian rows split over the
    tp group when tp > 1.  A dp mesh (tp=1) makes no collective call:
    scenarios never communicate."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the "
                         f"{mesh.dp}x{mesh.tp} mesh")

    def run(raw_xyz, raw_mask):
        with _tp_context(mesh):
            return batched_replay(raw_xyz, raw_mask, cfg, mesh.device)

    return run


def make_sharded_step(mesh: Mesh, cfg: LoamConfig):
    """fn(state, feats) -> (state, out): one pipeline_step (odometry,
    mapping on the publish flags' cadence, integration) of this rank's
    scenario block, state and features with a leading scenario axis on
    mesh.device, the rows split over the tp group when tp > 1."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the "
                         f"{mesh.dp}x{mesh.tp} mesh")
    check_config(cfg)

    def step(state, feats):
        configure_numerics()
        with _tp_context(mesh):
            return pipeline_step(state, feats, cfg, None)

    return step


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
