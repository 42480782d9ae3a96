"""One rank of the two-process loam_tpu_torch tests over gloo on loopback
(test_torch_distributed_multiprocess.py, test_torch_context.py, and on
the card test_torch_cuda.py).  Imports torch and
loam_tpu_torch only.

    python tests/torch_dcn_worker.py <host:port> <num_processes> <rank>
        <in.npz> <out.npz> replay|normal_equations [device]

replay: this rank's block of the global scenarios of in.npz (raw, msk;
B_global = B_local * num_processes) through replay_distributed over a
dp mesh, the poses gathered; then the first two global scenarios through
make_sharded_replay over a tp mesh (the Jacobian rows split over the
ranks); then dryrun_multichip at the tiny configuration.
normal_equations: residuals.normal_equations and
normal_equations_accumulated of in.npz's rows / accumulators under
row_sharding of a tp mesh over every rank.

Every torch.distributed call the package makes is counted by kind.
Writes its results to out.npz.  device (default cpu) is every rank's:
with "cuda" the ranks share the card over gloo.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object", "broadcast",
               "barrier", "reduce_scatter", "all_to_all", "send", "recv",
               "gather", "scatter", "reduce")


@contextlib.contextmanager
def count_collectives():
    """Counts, by name, the torch.distributed calls made inside."""
    import torch.distributed as dist

    counts = collections.Counter()
    saved = {n: getattr(dist, n) for n in COLLECTIVES}

    def spy(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    for n, fn in saved.items():
        setattr(dist, n, spy(n, fn))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def run_ranks(tmp, inputs: dict, what: str, nproc: int = 2,
              device: str = "cpu", timeout: float = 240, during=None):
    """Start nproc ranks of this script on a free loopback port with
    `inputs` (arrays, saved to tmp/in.npz), call during() while they run,
    and wait for them.  Returns (each rank's results, during()'s result);
    raises with a rank's output when one fails or times out."""
    np.savez(os.path.join(tmp, "in.npz"), **inputs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(tmp, f"r{r}.npz") for r in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"127.0.0.1:{port}",
         str(nproc), str(r), os.path.join(tmp, "in.npz"), outs[r], what,
         device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)]
    try:
        extra = during() if during is not None else None
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{log[-3000:]}")
    return [np.load(o) for o in outs], extra


def worker_cfg():
    """tests/torch_parity.parity_cfg() in the port's config class: the
    tiny configuration with rings of 512."""
    from loam_tpu_torch.entry import tiny_cfg

    return dataclasses.replace(tiny_cfg(), ring_width=512,
                               max_less_flat=2048, less_flat_ring_cap=256)


POSES = ("pose_odom", "pose_aft", "pose_integrated", "mapped")


def replay_case(rank: int, nproc: int, data, device) -> dict:
    from loam_tpu_torch.entry import dryrun_multichip, tiny_cfg
    from loam_tpu_torch.parallel import distributed as D
    from loam_tpu_torch.parallel import replay as R

    cfg = worker_cfg()
    raw, msk = data["raw"], data["msk"]
    b_local = raw.shape[0] // nproc
    mine = slice(rank * b_local, (rank + 1) * b_local)
    res = {}

    mesh = D.global_mesh(tp=1, device=device)
    with count_collectives() as dp_path:
        R.make_sharded_replay(mesh, cfg)(raw[mine], msk[mine])
    with count_collectives() as dp_total:
        out = D.replay_distributed(raw[mine], msk[mine], cfg, mesh=mesh)
    for n in POSES:
        res[f"dp_{n}"] = D.gather_metric(getattr(out.outs, n), mesh)
    res.update(dp_rate=out.per_chip_rate, dp_frames=out.frames_total,
               dp_elapsed=out.elapsed_s, dp_mesh=(mesh.dp, mesh.tp),
               dp_path_calls=sum(dp_path.values()),
               dp_all_reduce=dp_total["all_reduce"],
               dp_all_gather=dp_total["all_gather"])

    tp_mesh = D.global_mesh(tp=nproc, device=device)
    with count_collectives() as tp_calls:
        tp_out = R.make_sharded_replay(tp_mesh, cfg)(raw[:2], msk[:2])
    for n in POSES:
        res[f"tp_{n}"] = getattr(tp_out, n).cpu().numpy()
    res.update(tp_mesh=(tp_mesh.dp, tp_mesh.tp),
               tp_all_reduce=tp_calls["all_reduce"],
               tp_other=sum(tp_calls.values()) - tp_calls["all_reduce"])

    dry = dryrun_multichip(nproc, tiny_cfg(), device=device)
    res["dry_pose"] = np.stack([o.pose_integrated.cpu().numpy()
                                for o in dry])
    return res


def normal_equations_case(rank: int, nproc: int, data, device) -> dict:
    from loam_tpu_torch.ops import residuals
    from loam_tpu_torch.parallel import distributed as D
    from loam_tpu_torch.parallel.context import row_sharding

    mesh = D.global_mesh(tp=nproc, device=device)
    t = {k: torch.from_numpy(data[k]).to(mesh.device) for k in data.files}
    with count_collectives() as calls, row_sharding(mesh.tp_group):
        ata, atb = residuals.normal_equations(t["rows"], t["rhs"], t["keep"])
        acc_ata, acc_atb = residuals.normal_equations_accumulated(
            t["J"], t["C"], t["b"])
    return dict(ata=ata.cpu().numpy(), atb=atb.cpu().numpy(),
                acc_ata=acc_ata.cpu().numpy(), acc_atb=acc_atb.cpu().numpy(),
                all_reduce=calls["all_reduce"],
                calls=sum(calls.values()), tp_rank=mesh.tp_rank)


def main():
    addr, nproc, rank, inp, out, what = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        sys.argv[5], sys.argv[6])
    device = torch.device(sys.argv[7] if len(sys.argv) > 7 else "cpu")
    torch.set_num_threads(1)
    from loam_tpu_torch import configure_numerics
    from loam_tpu_torch.parallel import distributed as D

    configure_numerics()
    D.initialize(addr, nproc, rank, backend="gloo", device=device)
    case = {"replay": replay_case,
            "normal_equations": normal_equations_case}[what]
    res = case(rank, nproc, np.load(inp), device)
    np.savez(out, world=torch.distributed.get_world_size(), **res)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()
