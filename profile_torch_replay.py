"""Where the time goes in the port's replay on one NVIDIA GPU.

    python3 profile_torch_replay.py

Replays chip_smoke.py's 13 full-density synthetic sweeps with
LoamConfig() through loam_tpu_torch and prints, after a warm-up replay:
  * seconds per stage (ingest, feature extraction, odometry, mapping),
    with a synchronise around each stage;
  * a torch.profiler pass: device time by kernel, the device events
    counted, the four hand-written kernels' share, and the device busy
    share against an unprofiled replay's wall time;
  * peak device memory.
Every line that carries a time names the card and its power limit.
"""

from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke as CS

HAND_WRITTEN = ("knn_kernel", "odom_corr_kernel", "select_walk_kernel")


def _now() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def stage_seconds(raw_t, msk_t, cfg, dev):
    from loam_tpu_torch import frontend, mapping, odometry, pipeline
    from loam_tpu_torch.ops.features import extract_features

    t0 = _now()
    sweeps = frontend.ingest_sweep(raw_t, msk_t, cfg)
    t1 = _now()
    feats = extract_features(sweeps, cfg)
    t2 = _now()
    state = pipeline.PipelineState.create(cfg, dev)
    odo, maps = 0.0, []
    for k in range(raw_t.shape[0]):
        a = _now()
        odom_state, out = odometry.odometry_step(
            state.odom, feats.map(lambda t: t[k]), cfg)
        b = _now()
        odo += b - a
        map_state = state.map
        if bool(out.publish_to_mapping):
            map_state, _ = mapping.mapping_step(
                state.map, out.pose, out.corner_last, out.surf_last, cfg)
            maps.append(_now() - b)
        state = pipeline.PipelineState(odom=odom_state, map=map_state)
    return dict(ingest_s=t1 - t0, extract_s=t2 - t1, odometry_s=odo,
                mapping_s=sum(maps), mapping_frame_s=maps,
                total_s=_now() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_replay: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu.config import LoamConfig
    from loam_tpu_torch import configure_numerics, pipeline
    from loam_tpu_torch.ops.cuda import _build

    card = CS.card_line()
    dev = torch.device("cuda", 0)
    configure_numerics()
    cfg = LoamConfig()
    _build.build_all()
    raw, msk = CS.make_sweeps()
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    pipeline.replay_sweeps(raw_t[:3], msk_t[:3], cfg)

    print(f"stages [{card}]", json.dumps(stage_seconds(raw_t, msk_t, cfg,
                                                       dev)), flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipeline.replay_sweeps(raw_t, msk_t, cfg)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    mine = [r for r in rows if any(n in r[2] for n in HAND_WRITTEN)]

    torch.cuda.reset_peak_memory_stats()
    t0 = _now()
    pipeline.replay_sweeps(raw_t, msk_t, cfg)
    wall = _now() - t0
    print(f"replay {wall:.4f} s = {raw.shape[0] / wall:.3f} frames/s; "
          f"device time {device_s:.4f} s in {sum(r[1] for r in rows)} "
          f"events, busy share {device_s / wall:.4f}; hand-written "
          f"kernels {sum(r[0] for r in mine) / 1e3:.3f} ms in "
          f"{sum(r[1] for r in mine)} launches; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]")
    for us, count, key in rows[:20]:
        print(f"  {us / 1e3:10.3f} ms {count:7d}  {key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
