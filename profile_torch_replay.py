"""Where the time goes in the port's replay on one NVIDIA GPU.

    python3 profile_torch_replay.py [default|hybrid|cells|imu|batch ...]

Replays chip_smoke.py's 13 full-density synthetic sweeps through
loam_tpu_torch in each named mapping mode (chip_smoke.REPLAYS), for
"imu" chip_smoke.py's golden IMU scenario (40 sweeps with their IMU
windows), and for "batch" chip_smoke.py's batch of bench.py's workload
(B=8 scenarios x 17 full-density sweeps in lockstep through
parallel.replay.batched_replay, the hybrid cadence); all five when none
is named.  Prints, after a warm-up replay:
  * seconds per stage (ingest, IMU integration and deskew included;
    feature extraction, odometry, mapping), with a synchronise around
    each stage;
  * host reads a mapping frame: scalar reads (bool()/int() of a device
    tensor) and stream or device synchronisations the profiler saw
    inside mapping_step, over the mapping frames that solved (in any
    scenario of a batch);
  * a torch.profiler pass: device time by kernel (the twelve largest
    entries and every hand-written kernel, each with its rank), the
    device events counted, the hand-written kernels' share, and the
    device busy share against an unprofiled replay's wall time;
  * peak device memory.
Every line that carries a time names the card and its power limit.
"""

from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke as CS

HAND_WRITTEN = ("knn_kernel", "knn_nearest_kernel", "odom_corr_kernel",
                "select_walk_kernel", "kselect_group_kernel",
                "kselect_warp_kernel")
SCALAR_READ = "aten::_local_scalar_dense"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def _now() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def _count(prof, keys) -> int:
    return sum(e.count for e in prof.key_averages() if e.key in keys)


def stage_seconds(raw_t, msk_t, cfg, dev, imu=(),
                  count_reads: bool = False):
    """Seconds per stage of one scenario (raw_t (F, N, 3)) or of a
    lockstep batch (raw_t (B, F, N, 3)); imu: () or (ImuStream windows,
    sweep stamps), one scenario only.  With count_reads each
    mapping_step runs under its own profiler and the host reads are
    returned in place of the times (which the profiler distorts)."""
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu_torch import mapping, odometry, pipeline
    from loam_tpu_torch.ops.features import extract_features

    lead = raw_t.shape[:-2]
    t0 = _now()
    sweeps, imu_trans, map_rpy = pipeline.ingest_frames(
        raw_t.flatten(0, -3), msk_t.flatten(0, -2), cfg, *imu)
    t1 = _now()
    feats = extract_features(sweeps, cfg).map(
        lambda t: t.reshape(lead + t.shape[1:]))
    t2 = _now()
    if len(lead) == 1:          # one scenario: the B=1 case of the batch
        feats = feats.map(lambda t: t[None])
        if imu:
            imu_trans = imu_trans.map(lambda t: t[None])
            map_rpy = map_rpy[None]
    state = pipeline.PipelineState.create(cfg, dev,
                                          batch=feats.sharp.mask.shape[0])
    odo, maps, reads, syncs = 0.0, [], [], []
    for k in range(lead[-1]):
        a = _now()
        odom_state, out = odometry.odometry_step(
            state.odom, feats.map(lambda t: t[:, k]), cfg,
            imu=imu_trans.map(lambda t: t[:, k]) if imu else None)
        b = _now()
        odo += b - a
        map_state = state.map
        step = lambda: mapping.mapping_step(
            state.map, out.pose, out.corner_last, out.surf_last, cfg,
            imu_rpy=map_rpy[:, k] if imu else None)
        publish = bool(out.publish_to_mapping.any())
        if publish and count_reads:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                map_state, mout = step()
                torch.cuda.synchronize()
            if bool(mout.solved.any()):
                reads.append(_count(prof, (SCALAR_READ,)))
                syncs.append(_count(prof, SYNC_CALLS) - 1)   # less our own
        elif publish:
            map_state, _ = step()
            maps.append(_now() - b)
        state = pipeline.PipelineState(odom=odom_state, map=map_state)
    if count_reads:
        return dict(scalar_reads_per_solved_mapping_frame=reads,
                    sync_calls_per_solved_mapping_frame=syncs)
    return dict(ingest_s=t1 - t0, extract_s=t2 - t1, odometry_s=odo,
                mapping_s=sum(maps), mapping_frame_s=maps,
                total_s=_now() - t0)


def profile_mode(name, cfg, raw_t, msk_t, dev, card, imu=()) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu_torch import pipeline
    from loam_tpu_torch.parallel import replay as PR

    if raw_t.dim() == 4:
        replay = lambda x, m: PR.batched_replay(x, m, cfg)
        replay(raw_t[:, :3], msk_t[:, :3])
    else:
        replay = lambda x, m: pipeline.replay_sweeps(x, m, cfg, *imu)
        head = (imu[0].map(lambda t: t[:3]), imu[1][:3]) if imu else ()
        pipeline.replay_sweeps(raw_t[:3], msk_t[:3], cfg, *head)
    changes = {"imu": "golden IMU", "batch": "bench.py's workload, B=8 x "
               "F=17"}.get(name) or CS.REPLAYS[name][0]
    print(f"== {name} {changes} [{card}]")
    print(f"stages [{card}]", json.dumps(stage_seconds(raw_t, msk_t, cfg,
                                                       dev, imu)), flush=True)
    print("host reads", json.dumps(stage_seconds(raw_t, msk_t, cfg, dev, imu,
                                                 count_reads=True)),
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay(raw_t, msk_t)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    mine = [r for r in rows if any(n in r[2] for n in HAND_WRITTEN)]

    torch.cuda.reset_peak_memory_stats()
    t0 = _now()
    replay(raw_t, msk_t)
    wall = _now() - t0
    frames = msk_t.shape[:-1].numel()
    print(f"replay {wall:.4f} s = {frames / wall:.3f} frames/s; "
          f"device time {device_s:.4f} s in {sum(r[1] for r in rows)} "
          f"events, busy share {device_s / wall:.4f}; hand-written "
          f"kernels {sum(r[0] for r in mine) / 1e3:.3f} ms in "
          f"{sum(r[1] for r in mine)} launches; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]")
    for rank, (us, count, key) in enumerate(rows):
        if rank < 12 or (us, count, key) in mine:
            print(f"  #{rank + 1:<4d} {us / 1e3:10.3f} ms {count:7d}  "
                  f"{key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_replay: no CUDA device")
    known = list(CS.REPLAYS) + ["imu", "batch"]
    modes = sys.argv[1:] or known
    unknown = [m for m in modes if m not in known]
    if unknown:
        raise SystemExit(f"unknown mode {unknown}; one of {known}")
    from loam_tpu_torch import configure_numerics
    from loam_tpu_torch.entry import bench_cfg
    from loam_tpu_torch.ops.cuda import _build

    card = CS.card_line()
    dev = torch.device("cuda", 0)
    configure_numerics()
    _build.build_all()
    raw, msk = CS.make_sweeps()
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    for name in modes:
        if name == "imu":
            (iraw, imsk, stream, t_scans), _ = CS.imu_inputs(dev)
            profile_mode(name, CS.imu_config(), iraw, imsk, dev, card,
                         (stream, t_scans))
        elif name == "batch":
            braw, bmsk, _ = CS.batch_sweeps()
            profile_mode(name, bench_cfg(),
                         torch.tensor(braw, device=dev),
                         torch.tensor(bmsk, device=dev), dev, card)
        else:
            profile_mode(name, CS.replay_config(name), raw_t, msk_t, dev,
                         card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
