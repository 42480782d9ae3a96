"""Command-line launcher (counterpart of loam_tpu/cli.py; the roslaunch
equivalent, SURVEY.md §2 C19).

The reference is started with `roslaunch loam_velodyne loam_velodyne.launch`
plus `rosbag play` (README.md:27-32 in the reference); the hector variant
only remaps the IMU topic (launch/hector_loam_velodyne.launch:6-8).
Standalone, on the CUDA device unless --device says otherwise:

    python -m loam_tpu_torch --bag nsh_indoor_outdoor.bag --out-dir out/
    python -m loam_tpu_torch --bag X.bag --mode online  # streaming engine
    python -m loam_tpu_torch --synthetic 32 --out-dir out/   # no data needed
    python -m loam_tpu_torch --synthetic 3 --ring-width 512 --device cpu

Outputs: TUM trajectories for every stage (`odom.tum`, `aft_mapped.tum`,
`integrated.tum` — the three pose topics) and a PLY of the final map
(the /laser_cloud_surround equivalent); `--viz` adds `viz.png` and
`viewer.html`.  `--mode online` feeds the sweeps, with the IMU samples
interleaved ahead of each, through the threaded streaming engine and
writes its integrated trajectory; `--live-port` serves its live viewer.
A recorded bag has no deadline, so the online loop hands the engine the
next sweep once it has finished the last (the JAX command line pushes
them all at once, and its engine drops what its queues cannot hold).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import sys
import time

PROG = "loam_tpu_torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="LOAM on one NVIDIA GPU (PyTorch + CUDA): lidar "
                    "odometry and mapping",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--bag", help="rosbag 2.0 file with lidar (+IMU) data")
    src.add_argument(
        "--synthetic", type=int, metavar="F",
        help="replay F synthetic frames instead of a bag",
    )
    p.add_argument("--cloud-topic", default="/velodyne_points")
    p.add_argument(
        "--imu-topic", default="/imu/data",
        help="IMU topic ('/raw_imu' for the hector variant; '' disables)",
    )
    p.add_argument("--mode", choices=("offline", "online"),
                   default="offline",
                   help="offline: batch replay; online: threaded "
                        "streaming engine with lossy queues")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA "
                        "device, an error without one); 'cpu' runs every "
                        "kernel's plain PyTorch version on the CPU")
    p.add_argument("--out-dir", default="loam_out")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--skip", type=int, default=None,
                   help="initial sweeps to drop (default: systemDelay)")
    p.add_argument("--ring-width", type=int, default=2048)
    p.add_argument(
        "--knn-cadence", choices=("strict", "fast"), default="strict",
        help="mapping exact-kNN re-query cadence: strict = the "
             "reference's per-iteration kd re-query (default); fast = "
             "fused top-8 gather per 5-iteration round + per-iteration "
             "re-rank (5 cm oracle gate holds — see "
             "config.map_exact_regather_every)",
    )
    p.add_argument("--report-timing", action="store_true")
    p.add_argument(
        "--stream-clouds", action="store_true",
        help="emit the registered full-res cloud every mapping frame "
             "(/velodyne_cloud_registered) and the map surround cloud "
             "every mapFrameNum-th mapping frame (/laser_cloud_surround) "
             "as PLY streams under OUT_DIR/clouds/",
    )
    p.add_argument("--viz", action="store_true",
                   help="offline mode: write viz.png + viewer.html (the "
                        "rviz displays: map surround, trajectories); needs "
                        "matplotlib")
    p.add_argument(
        "--live-port", type=int, default=-1,
        help="online mode: serve the LIVE viewer (rviz equivalent — "
             "pose trail + ~1 Hz map surround over HTTP polling) on "
             "this port (0 = auto-pick); -1 disables",
    )
    p.add_argument(
        "--golden-compare", action="store_true",
        help="additionally replay the SAME sweeps through the "
             "straight-line NumPy reference oracle (tests/golden — the "
             "transcription of all four reference nodes) and report the "
             "trajectory ATE against it: the BASELINE.md north-star gate "
             "(<= 5 cm, the reference README.md:22-35 bag-replay "
             "workflow) as ONE command.  Writes golden_*.tum next to the "
             "pipeline outputs; requires a repo checkout (tests/golden "
             "importable)",
    )
    return p


def check_args(args) -> None:
    """Refuse, before any work, an option its mode does not run or a
    missing dependency (never a silent fallback to another path)."""
    if args.golden_compare and args.mode != "offline":
        raise ValueError("--golden-compare holds the offline replay to the "
                         "oracle: it needs --mode offline")
    if args.live_port >= 0 and args.mode != "online":
        raise ValueError("--live-port serves the streaming engine's live "
                         "viewer: it needs --mode online")
    if args.viz:
        if args.mode != "offline":
            raise ValueError("--viz draws the offline replay: it needs "
                             "--mode offline (--live-port is the online "
                             "viewer)")
        if importlib.util.find_spec("matplotlib") is None:
            raise RuntimeError("--viz needs matplotlib, which is not "
                               "installed: install it or leave out --viz")


def _config(args):
    from .config import LoamConfig

    return dataclasses.replace(
        LoamConfig(),
        ring_width=args.ring_width,
        map_exact_regather_every=5 if args.knn_cadence == "fast" else 1,
    )


def _load_data(args, cfg):
    import numpy as np

    if args.bag:
        from .io import rosbag as rb

        skip = cfg.system_delay if args.skip is None else args.skip
        raw, mask, stamps = rb.load_sweeps(
            args.bag, topic=args.cloud_topic, max_points=cfg.max_points,
            skip=skip,
        )
        imu = None
        if args.imu_topic:
            t, rpy, acc = rb.load_imu_stream(args.bag, args.imu_topic)
            if t.size:
                imu = (t, rpy, acc)
        return raw, mask, stamps, imu
    # synthetic
    from .io import synth

    F = args.synthetic
    world = synth.make_world(seed=0)
    poses = synth.straight_trajectory(F, speed=1.0, yaw_rate=0.05)
    poses = np.vstack([poses[:1], poses])[: F + 1]
    xs, ms = [], []
    for k in range(F):
        xyz, m = synth.simulate_sweep(
            world, poses[k], poses[k + 1], n_azimuth=900, seed=k
        )
        n = cfg.max_points
        xs.append(xyz[:n])
        ms.append(m[:n])
    stamps = np.arange(F) * cfg.scan_period
    return np.stack(xs), np.stack(ms), stamps, None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_args(args)

    import numpy as np
    import torch

    from . import pipeline, resolve_device
    from .io import export
    from .utils import tracing

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = _config(args)
    raw, mask, stamps, imu = _load_data(args, cfg)
    if args.max_frames:
        raw, mask = raw[: args.max_frames], mask[: args.max_frames]
        stamps = stamps[: args.max_frames]
    F = raw.shape[0]
    print(f"[{PROG}] {F} sweeps, {raw.shape[1]} point capacity, "
          f"imu={'yes' if imu is not None else 'no'}, device={device}",
          flush=True)

    if args.mode == "online":
        return _online(args, cfg, raw, mask, stamps, imu, device)

    if args.stream_clouds:
        cfg = dataclasses.replace(cfg, emit_registered=True)
    streams = None
    t_scans = None
    if imu is not None:
        t, rpy, acc = imu
        t0 = stamps[0]
        streams = _window_imu(t - t0, rpy, acc, stamps - t0, cfg,
                              device=device)
        t_scans = torch.as_tensor(stamps - t0, dtype=torch.float32,
                                  device=device)
    with tracing.stage("replay") as h:
        if args.stream_clouds:
            outs, final = _replay_streaming_clouds(
                args, cfg, raw, mask, streams, t_scans, device
            )
        else:
            outs, final = pipeline.replay_sweeps(
                raw, mask, cfg, streams, t_scans, return_state=True,
                device=device,
            )
        h["out"] = outs
    if args.report_timing:
        print(tracing.report(), flush=True)

    for name, poses in (("odom", outs.pose_odom),
                        ("aft_mapped", outs.pose_aft),
                        ("integrated", outs.pose_integrated)):
        export.save_trajectory_tum(
            os.path.join(args.out_dir, name + ".tum"), stamps,
            poses.cpu().numpy(),
        )

    # final map surround cloud (/laser_cloud_surround equivalent,
    # src/laserMapping.cpp:1038-1058): corner + surf voxel centroids
    tables = (final.map.corner_map, final.map.surf_map)
    map_xyz = np.concatenate([t.centroids().cpu().numpy() for t in tables])
    map_live = np.concatenate([t.live().cpu().numpy() for t in tables])
    export.save_cloud_ply(
        os.path.join(args.out_dir, "map_surround.ply"), map_xyz, map_live
    )
    if args.viz:
        _viz(args, outs, map_xyz, map_live, F)
    print(f"[{PROG}] wrote {args.out_dir}/{{odom,aft_mapped,integrated}}"
          f".tum ({F} poses) + map_surround.ply "
          f"({int(map_live.sum())} pts)", flush=True)

    if args.golden_compare:
        return _golden_compare(args, cfg, raw, mask, stamps, imu, outs)
    return 0


def _online(args, cfg, raw, mask, stamps, imu, device) -> int:
    """The streaming engine over the loaded sweeps, IMU samples pushed
    ahead of the sweep they cover as the live subscriptions would
    deliver them, each sweep once the engine has finished the last;
    writes the integrated trajectory."""
    from .io import export
    from .runtime.streaming import StreamingEngine

    if args.live_port >= 0 or args.stream_clouds:
        # the live viewer's 4th rviz display (/velodyne_cloud_registered)
        # needs the engine to thread the full-res cloud through mapping
        cfg = dataclasses.replace(cfg, emit_registered=True)
    eng = StreamingEngine(cfg, device=device)
    eng.start()
    live = None
    try:
        if args.live_port >= 0:
            from .viz_live import LiveServer

            live = LiveServer(eng, port=args.live_port).start()
            print(f"[{PROG}] live viewer at {live.url}", flush=True)
        F = raw.shape[0]
        t0 = time.perf_counter()
        t_base = stamps[0]
        imu_cursor = 0
        for k in range(F):
            t_scan = float(stamps[k] - t_base)
            if imu is not None:
                it, irpy, iacc = imu
                horizon = t_scan + cfg.scan_period + 0.05
                while imu_cursor < it.shape[0] and \
                        it[imu_cursor] - t_base <= horizon:
                    eng.push_imu(it[imu_cursor] - t_base, irpy[imu_cursor],
                                 iacc[imu_cursor])
                    imu_cursor += 1
            eng.push_sweep(raw[k], mask[k], t_scan)
            eng.drain(timeout_s=600)
        eng.drain(timeout_s=600)
        dt = time.perf_counter() - t0
        st = eng.stats()
        traj = eng.trajectory()
    finally:
        if live is not None:
            live.stop()
        eng.stop()
    print(f"[{PROG}] online: {st.odom_frames} odometry frames, "
          f"{st.map_frames} mapping frames, "
          f"{st.queue_stats['raw']['dropped']} dropped, "
          f"{F / dt:.1f} sweeps/s", flush=True)
    export.save_trajectory_tum(
        os.path.join(args.out_dir, "integrated.tum"),
        stamps[: traj.shape[0]], traj,
    )
    return 0


def _viz(args, outs, map_xyz, map_live, F: int) -> None:
    """viz.png (the four rviz displays) and viewer.html of the replay."""
    from . import viz

    trajs = {"integrated": outs.pose_integrated,
             "aft_mapped": outs.pose_aft, "odom": outs.pose_odom}
    viz.plot_dashboard(os.path.join(args.out_dir, "viz.png"), trajs,
                       map_xyz=map_xyz, map_mask=map_live,
                       title=f"{PROG} — {F} sweeps")
    viz.export_html_viewer(os.path.join(args.out_dir, "viewer.html"), trajs,
                           clouds={"map_surround": (map_xyz, map_live)})
    print(f"[{PROG}] wrote {args.out_dir}/viz.png, viewer.html", flush=True)


def _golden_compare(args, cfg, raw, mask, stamps, imu, outs) -> int:
    """Replay the same sweeps through the NumPy reference oracle and
    report the ATE of every pipeline trajectory against it — the
    BASELINE.md gate (<= 5 cm on the reference's bag-replay workflow,
    reference README.md:22-35) as a one-command verdict.

    The oracle is the test-only transcription under tests/golden (kept
    out of the installed package on purpose), so this needs a repo
    checkout."""
    import json

    import numpy as np

    from . import metrics
    from .io import export

    tests_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests",
    )
    if not os.path.exists(os.path.join(tests_dir, "golden", "pipeline.py")):
        print(f"[{PROG}] --golden-compare needs the repo checkout "
              f"(tests/golden not found near {tests_dir})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, tests_dir)
    from golden import pipeline as golden_pipeline

    t0 = time.perf_counter()
    if imu is not None:
        # convert loader conventions ((roll, pitch, yaw), raw velodyne
        # acceleration) to the oracle's internal form — the imuHandler
        # math of imu.imu_from_raw (src/scanRegistration.cpp:638-652)
        t, rpy, acc = imu
        g = 9.81
        roll, pitch, yaw = rpy[:, 0], rpy[:, 1], rpy[:, 2]
        acc_int = np.stack([
            acc[:, 1] - np.sin(roll) * np.cos(pitch) * g,
            acc[:, 2] - np.cos(roll) * np.cos(pitch) * g,
            acc[:, 0] + np.sin(pitch) * g,
        ], -1).astype(np.float32)
        pyr = np.stack([pitch, yaw, roll], -1).astype(np.float32)
        base = stamps[0]
        oracle = golden_pipeline.run_pipeline_imu(
            raw, mask, (t - base).astype(np.float32), pyr, acc_int,
            (stamps - base).astype(np.float32),
        )
    else:
        oracle = golden_pipeline.run_pipeline(
            raw, mask,
            truncate_upward_scan=cfg.emulate_upward_scan_truncation,
        )
    dt = time.perf_counter() - t0
    print(f"[{PROG}] golden oracle replay: {raw.shape[0]} frames in "
          f"{dt:.1f}s", flush=True)

    for name, key in (("golden_odom", "odom"),
                      ("golden_aft_mapped", "aft"),
                      ("golden_integrated", "integrated")):
        export.save_trajectory_tum(
            os.path.join(args.out_dir, name + ".tum"), stamps,
            oracle[key],
        )

    verdict = {}
    for key, est in (("odom", outs.pose_odom),
                     ("aft", outs.pose_aft),
                     ("integrated", outs.pose_integrated)):
        ate = metrics.ate_rmse(est[:, 3:6], oracle[key][:, 3:6])
        verdict[f"ate_{key}_cm"] = round(100.0 * ate, 3)
    verdict["gate_cm"] = 5.0
    verdict["pass"] = bool(verdict["ate_integrated_cm"] <= 5.0)
    print(json.dumps({"golden_compare": verdict}), flush=True)
    return 0 if verdict["pass"] else 1


def _replay_streaming_clouds(args, cfg, raw, mask, streams, t_scans,
                             device):
    """Chunked offline replay honoring the reference's cloud cadences
    (src/laserMapping.cpp:1038-1069): the registered full-res cloud is
    written every mapping frame, the surround cloud at the end of every
    chunk of map_frame_num * (skip_frame_num + 1) sweeps (~1 Hz, the
    JAX package's chunks).  The state carries from chunk to chunk, and
    the mapping cadence follows the odometry's publish flags, so the
    chunking moves neither the cadence nor the poses."""
    import numpy as np
    import torch

    from . import mapping, pipeline
    from .io import export
    from .types import tree_map

    cloud_dir = os.path.join(args.out_dir, "clouds")
    os.makedirs(cloud_dir, exist_ok=True)
    F = raw.shape[0]
    chunk = cfg.map_frame_num * (cfg.skip_frame_num + 1)
    state = None
    outs_list = []
    n_reg = 0
    n_sur = 0
    for s in range(0, F, chunk):
        e = min(s + chunk, F)
        kw = {}
        if streams is not None:
            kw = dict(imu_streams=streams.map(lambda x: x[s:e]),
                      t_scans=t_scans[s:e])
        outs_c, state = pipeline.replay_sweeps(
            raw[s:e], mask[s:e], cfg, **kw, state0=state,
            return_state=True, device=device,
        )
        outs_c = tree_map(lambda t: t.cpu(), outs_c)
        outs_list.append(outs_c)
        reg = outs_c.registered
        for k in np.nonzero(outs_c.mapped.numpy())[0]:
            export.save_cloud_ply(
                os.path.join(cloud_dir, f"registered_{s + int(k):04d}.ply"),
                reg.xyz[k].numpy(), reg.mask[k].numpy(),
            )
            n_reg += 1
        sur = mapping.surround_cloud(state.map)
        export.save_cloud_ply(
            os.path.join(cloud_dir, f"surround_{e - 1:04d}.ply"),
            sur.xyz.cpu().numpy(), sur.mask.cpu().numpy(),
        )
        n_sur += 1
    print(f"[{PROG}] wrote {n_reg} registered + {n_sur} surround "
          f"clouds to {cloud_dir}", flush=True)
    outs = tree_map(lambda *xs: torch.cat(xs, 0), *outs_list)
    return outs, state


def _window_imu(t, rpy, acc, stamps, cfg, capacity: int = 256,
                margin: float = 0.05, device=None):
    """Slice the global IMU stream into per-frame fixed-capacity windows
    on the host and run the imuHandler conversion (gravity removal + axis
    swizzle, src/scanRegistration.cpp:638-652) on `device` (None: the
    CUDA device) — the per-sweep circular-buffer view of
    src/scanRegistration.cpp:286-331.

    t / stamps must already be normalized to a small epoch (float32).
    rpy: (M, 3) (roll, pitch, yaw); acc: (M, 3) raw velodyne-frame
    linear acceleration.  Returns an ImuStream with a leading frame axis.
    """
    import numpy as np
    import torch

    from . import imu as imu_mod, resolve_device

    device = resolve_device(device)
    F = stamps.shape[0]
    ts = np.zeros((F, capacity), np.float32)
    rp = np.zeros((F, capacity, 3), np.float32)
    ac = np.zeros((F, capacity, 3), np.float32)
    mk = np.zeros((F, capacity), bool)
    for k in range(F):
        lo = int(np.searchsorted(t, stamps[k] - margin))
        hi = min(int(np.searchsorted(
            t, stamps[k] + cfg.scan_period + margin)), lo + capacity)
        n = hi - lo
        ts[k, :n] = t[lo:hi]
        rp[k, :n] = rpy[lo:hi]
        ac[k, :n] = acc[lo:hi]
        mk[k, :n] = True
    return imu_mod.imu_from_raw(
        *(torch.as_tensor(a, device=device) for a in (ts, rp, ac, mk))
    )


if __name__ == "__main__":
    sys.exit(main())
