"""Scenario replay over several processes (counterpart of
loam_tpu/parallel/distributed.py).

The JAX package assembles one global array from every process's shard
and runs one jitted SPMD program, GSPMD inserting the collectives.  The
port is SPMD by hand: one process a rank, torch.distributed process
groups, and every collective an explicit call.  Each rank loads its own
scenarios and replays them on its device (parallel/replay.py's mesh);
scenarios never communicate, so the only traffic of a data-parallel
replay is the timing all_reduce at its end and the metric gathers the
caller asks for.

Backends: NCCL for one rank a card, gloo for ranks that share a card or
run on the CPU.  gloo reduces and broadcasts CUDA tensors but does not
gather them, so gather_metric gathers host copies under gloo.

In one process with no process group everything is the (1, 1) mesh and
makes no collective call.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import LoamConfig
from . import replay as replay_mod
from .replay import Mesh


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None) -> None:
    """Bring up the process group of a multi-process run: call it at
    program start in every rank.  A no-op in one process (no address and
    no process count, or one process and no backend asked for); a world
    of one process is brought up only when the caller names its backend.
    Otherwise init_process_group over tcp://coordinator_address with
    world size num_processes and rank process_id.

    backend None is "nccl" for a CUDA device and "gloo" for the CPU;
    "gloo" with a CUDA device is taken as asked, for ranks that share one
    card (NCCL refuses two ranks on one card).  device: this rank's
    device (None: the current CUDA device, raises without one); a CUDA
    device with an index is made the rank's current device."""
    if coordinator_address is None and num_processes is None:
        return
    if num_processes is not None and num_processes <= 1 and backend is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address, "
                         "num_processes and process_id")
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def global_mesh(tp: int = 1, device=None) -> Mesh:
    """The (dp, tp) mesh over every rank of the world; device as in
    initialize."""
    return replay_mod.make_mesh(tp=tp, devices=device)


def _host_side(group) -> bool:
    """Whether a gather over group runs on host copies: gloo cannot
    gather CUDA tensors, NCCL gathers nothing else."""
    return dist.get_backend(group) != "nccl"


def shard_scenarios_from_local(local_raw, local_mask, mesh: Mesh):
    """This rank's scenarios local_raw (B_local, F, N, 3) and local_mask
    (B_local, F, N), NumPy arrays or tensors, on mesh.device.  Every rank
    must hold the same B_local (the global batch is B_local per dp
    block), which one small all_gather over the world checks when there
    is more than one rank."""
    raw = torch.as_tensor(local_raw, dtype=torch.float32).to(mesh.device)
    mask = torch.as_tensor(local_mask, dtype=torch.bool).to(mesh.device)
    if _grouped() and dist.get_world_size() > 1:
        at = torch.device("cpu") if _host_side(None) else mesh.device
        mine = torch.tensor([raw.shape[0]], device=at)
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        sizes = [int(t) for t in every]
        if len(set(sizes)) != 1:
            raise ValueError(f"the ranks hold {sizes} scenarios: every "
                             "rank must hold the same B_local")
    return raw, mask


@dataclasses.dataclass
class ReplayResult:
    outs: object          # FrameOutput of this rank's block, (B_local, F)
    frames_total: int     # scan-matches of the global batch
    elapsed_s: float      # the slowest rank's seconds
    per_chip_rate: float  # scan-matches / s / rank


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def replay_distributed(local_raw, local_mask, cfg: LoamConfig,
                       mesh: Mesh | None = None, tp: int = 1,
                       warmup: bool = True, device=None) -> ReplayResult:
    """Replay this rank's scenarios (make_sharded_replay) and time it:
    a warm-up run (library handles, the allocator), then a timed run
    ending in a device synchronize.  The ranks agree on the slowest
    rank's seconds with one all_reduce; per_chip_rate is B_global * F
    over those seconds over the mesh's ranks, B_global counting each dp
    block once (the ranks of a tp group replay the same scenarios).
    mesh None is global_mesh(tp, device)."""
    if mesh is None:
        mesh = global_mesh(tp=tp, device=device)
    raw, mask = shard_scenarios_from_local(local_raw, local_mask, mesh)
    run = replay_mod.make_sharded_replay(mesh, cfg)
    if warmup:
        run(raw, mask)
        _sync(mesh.device)
    t0 = time.perf_counter()
    outs = run(raw, mask)
    _sync(mesh.device)
    dt = _allreduce_max(time.perf_counter() - t0, mesh.device)
    b_global = raw.shape[0] * mesh.dp
    frames = b_global * raw.shape[1]
    return ReplayResult(outs=outs, frames_total=frames, elapsed_s=dt,
                        per_chip_rate=frames / dt / (mesh.dp * mesh.tp))


def _allreduce_max(x: float, device, group=None) -> float:
    """The largest x of the ranks of group (None: the world), reduced on
    device; x itself in one process with no process group."""
    if not _grouped():
        return float(x)
    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def gather_metric(x, mesh: Mesh | None = None) -> np.ndarray:
    """Every rank's block of a per-scenario metric x (B_local, ...),
    gathered over the dp group in dp-rank order: the global
    (B_global, ...) array as NumPy, on every rank.  Under gloo the
    blocks travel as host copies (gloo gathers no CUDA tensor), under
    NCCL on the device.  In one process with no process group, x as
    NumPy."""
    x = torch.as_tensor(x)
    if not _grouped():
        return x.detach().cpu().numpy()
    group = None if mesh is None else mesh.dp_group
    if mesh is not None and not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the mesh")
    x = x.detach().contiguous()
    if _host_side(group):
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).cpu().numpy()


def scaling_efficiency(cfg: LoamConfig, b_per_chip: int = 2,
                       frames: int = 8, n_points: int = 4096,
                       dp_sizes=(1, None), seed: int = 0, device=None):
    """Weak scaling: scan-matches/s/rank at each dp size on random
    scenarios, made from `seed` with NumPy as the JAX harness makes
    them (a (b, F, N, 3) normal cloud at 10 m, 90% of points valid, for
    b = b_per_chip * s; None is every rank).  Size s runs on a submesh of
    the first s ranks, each replaying its block of b_per_chip scenarios
    after a warm-up; the other ranks wait in the all_reduce that agrees
    on the slowest member's seconds.  Every rank must call it.  Returns
    {"rates": {s: rate}, "efficiency": the largest size's rate over the
    smallest's}."""
    world = dist.get_world_size() if _grouped() else 1
    sizes = [s if s is not None else world for s in dp_sizes]
    rng = np.random.default_rng(seed)
    rates: dict[int, float] = {}
    for s in sorted(set(sizes)):
        mesh = replay_mod.make_mesh(n_devices=s, devices=device)
        b = b_per_chip * s
        raw = rng.normal(0, 10, (b, frames, n_points, 3)).astype(np.float32)
        mask = np.ones((b, frames), bool)[:, :, None] & (
            rng.random((b, frames, n_points)) > 0.1
        )
        dt = 0.0
        if mesh.member:
            block = slice(mesh.dp_rank * b_per_chip,
                          (mesh.dp_rank + 1) * b_per_chip)
            run = replay_mod.make_sharded_replay(mesh, cfg)
            raw_d = torch.as_tensor(raw[block]).to(mesh.device)
            mask_d = torch.as_tensor(mask[block]).to(mesh.device)
            run(raw_d, mask_d)
            _sync(mesh.device)
            t0 = time.perf_counter()
            run(raw_d, mask_d)
            _sync(mesh.device)
            dt = time.perf_counter() - t0
        dt = _allreduce_max(dt, mesh.device)
        rates[s] = b * frames / dt / s
    lo, hi = min(rates), max(rates)
    return {
        "rates": rates,
        "efficiency": rates[hi] / rates[lo] if lo != hi else 1.0,
    }
