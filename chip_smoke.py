"""Drive the PyTorch/CUDA port (loam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. require a CUDA device; print its name and power limit;
  2. build every kernel from loam_tpu_torch/csrc (one nvcc per source,
     all started together);
  3. hold each kernel against its plain PyTorch version at the replays'
     shapes on seeded inputs, every output bit for bit (indices,
     bit-fields, coordinates and squared distances), the neighbour kernels
     also on tie-heavy lattice clouds;
     time both with CUDA events (median of 20 single calls, which for a
     kernel of a few microseconds is the wrapper's host time; device_ms
     is the time a call with the host out of the way, 50 calls queued
     behind a long matrix product), time the one PyTorch library
     expression that computes the same function where there is one
     (cdist + topk for the k-NN kernels, topk + gather for kselect), and
     compute each kernel's bound: the larger of its bytes (each input
     read once, each output written once) over 3.35 TB/s and its
     operations (counted for the live inputs and tile windows of this
     run) over 67 TFLOP/s;
  4. replay 13 full-density synthetic VLP-16 sweeps through
     loam_tpu_torch.pipeline.replay_sweeps three times: LoamConfig()
     unchanged (strict exact k-NN), map_exact_regather_every=5 (the
     hybrid cadence) and map_exact_knn=False (the cell-bucket map).
     Launch counts are zeroed before each replay and read after it; a
     kernel of that replay's path with no launch fails the run.  Each
     integrated trajectory must be finite, within 5 cm ATE of the NumPy
     golden oracle (tests/golden) on the same sweeps, and have the
     oracle's mapping cadence;
  5. replay the golden IMU scenario of tests/test_golden_parity_imu.py
     whole (40 sweeps of 600 azimuths along the oscillating trajectory,
     a 200 Hz IMU stream cut into per-frame windows, the cell-bucket
     map) with its IMU streams, and hold it to that test's gates against
     tests/golden/pipeline.run_pipeline_imu: odometry ATE < 2 cm,
     integrated ATE < 5 cm, pitch/roll within 0.3 deg, ATE against the
     ground truth < 0.30 m, and a no-IMU rerun that moves the integrated
     trajectory by more than 1 mm; it must launch select_walk, knn_topk,
     odom_corr and knn_select, and never knn_topk_dyn;
  6. replay bench.py's workload through loam_tpu_torch.parallel.replay.
     batched_replay: B=8 scenarios x F=17 full-density sweeps at
     bench.py's configuration (hybrid cadence, no drift re-gather), the
     scenarios made by bench.py's recipe.  Each scenario's poses must be
     finite and within 1e-4 rad / 1e-3 m of its own single-scenario
     replay on the card, with the same cadence; the batch must launch
     knn_topk, odom_corr, knn_topk_dyn, knn_select and select_walk, and
     launch knn_topk fewer times than the eight single replays together.
     Prints frames/s of the batch and of the single replays, peak device
     memory and the host reads of a mapping frame, batched and single;
  7. the long golden gates of tests/test_golden_parity.py on the card:
     100 straight frames of 600 azimuths at its CFG (the cell-bucket map)
     against tests/golden/pipeline.run_pipeline (odometry ATE < 1 cm,
     integrated and aft-mapped ATE < 5 cm, the oracle's cadence, yaw
     within 0.2 deg), and its first 30 frames at CFG_EXACT with
     map_exact_regather_every=5 (integrated ATE < 5 cm);
  8. the offline command line (python -m loam_tpu_torch) at full width:
     (a) `--synthetic 24 --stream-clouds --golden-compare --report-timing`
     as a subprocess (the CLI's own recipe, 900 azimuths, strict exact
     k-NN): exit 0, a passing golden verdict (integrated ATE < 5 cm), 24
     finite poses in each TUM file, map points, and the cloud files the
     cadence rule predicts (a registered cloud every mapping frame, a
     surround cloud every chunk); (b) a bag of 16 full-density sweeps
     (1800 azimuths) along the oscillating trajectory with its 200 Hz
     IMU stream as raw sensor_msgs/Imu messages, run through cli.main
     in this process with `--knn-cadence fast --stream-clouds
     --golden-compare`: it must launch all five kernels, pass its gate,
     and its integrated.tum must equal, to the file's six decimals, a
     pipeline.replay_sweeps of the same loaded arrays and IMU windows;
     (c) a checkpointed_replay of that bag's features (every 4 frames)
     run for 8 frames, then resumed from the latest checkpoint by a new
     manager: every pose equals an uninterrupted replay's bit for bit.
     Prints frames/s, the ATEs, the timing reports, the bag's load
     seconds, the checkpoint milliseconds and peak device memory.
The kernel rows carry the batch's shapes too (B=8 scenarios), each
compared bit for bit.  The last lines are the smoke's seconds, the
kernels JSON, the card's name and power limit, and {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 21
FRAMES = 13
N_AZIMUTH = 1800
ATE_GATE = 0.05    # metres, integrated trajectory vs the golden oracle
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # fp32 outside the tensor cores
PAIR_OPS = 9       # 3 sub, 3 mul, 2 add, 1 compare per query/point pair
# Times of the versions that the redesigned kernels replaced, by kernel
# and shape prefix (the bracketed times of PERF.md's kernel table; NVIDIA
# H100 80GB HBM3, 700.00 W).  Printed beside the new times on the text
# lines only: the kernels JSON holds what this run measured.
# name -> (what it was, how it was timed, {shape prefix: ms})
EARLIER_MS = {
    "knn_topk": ("the one-thread-a-query kernel", "a call",
                 {"B=1,Q=256,M=2048,": 0.0627, "B=1,Q=512,M=16384,": 0.2656}),
    "odom_corr": ("the one-thread-a-query kernel", "a call",
                  {"B=1,Q=256,M=2048,": 0.1353,
                   "B=1,Q=512,M=16384,": 0.4219}),
    "knn_topk_dyn": ("the one-thread-a-query kernel", "on the device",
                     {"B=1,Q=2048,M=32768,": 0.3393,
                      "B=1,Q=8192,M=65536,": 0.2228}),
    "knn_topk_dyn_k8": ("the one-thread-a-query kernel", "on the device",
                        {"B=1,Q=8192,M=65536,": 0.3545}),
    "kselect": ("the one-warp-a-query kernel", "on the device",
                {"Q=8192,C=8,k=5,": 0.0093, "Q=8192,C=24,k=5,": 0.0091,
                 "Q=2048,C=864,k=24,": 0.0276}),
    "select_walk": ("the one-thread-a-ring kernel", "on the device",
                    {"B=1,R=16,": 0.0919, "B=8,R=272,": 0.1188,
                     "B=1,R=208,": 0.1137}),
}

# name -> (config changes, wrappers that must launch, must not launch)
REPLAYS = {
    "default": ({}, ("knn_topk", "knn_topk_dyn", "odom_corr", "select_walk"),
                ("knn_select",)),
    "hybrid": (dict(map_exact_regather_every=5),
               ("knn_topk", "knn_topk_dyn", "odom_corr", "select_walk",
                "knn_select"), ()),
    "cells": (dict(map_exact_knn=False),
              ("knn_topk", "odom_corr", "select_walk", "knn_select"),
              ("knn_topk_dyn",)),
}


# the golden IMU scenario (tests/test_golden_parity_imu.py:30-44)
IMU_FRAMES = 40
IMU_AZIMUTH = 600
IMU_SEED = 11
IMU_RATE = 200.0     # Hz
IMU_T0 = 0.06        # first sweep stamp (the stream starts at t=0)
IMU_LEAD = 0.05      # window lead before the sweep
IMU_HORIZON = 0.13   # samples that have arrived when the sweep is handled
IMU_CAP = 64
IMU_PATH = (("knn_topk", "odom_corr", "select_walk", "knn_select"),
            ("knn_topk_dyn",))
# its gates (tests/test_golden_parity_imu.py:123-177)
IMU_ODOM_GATE = 0.02         # m, odometry ATE vs the oracle
IMU_ATTITUDE_GATE = 0.3      # deg, largest pitch/roll gap
IMU_GT_GATE = 0.30           # m, integrated ATE vs the ground truth
IMU_MOVES = 1e-3             # m, the IMU must move the trajectory

# bench.py's workload (bench.py:448-449, its _cfg() and _data recipe)
BATCH_B = 8
BATCH_F = 17
BATCH_PATH = ("knn_topk", "odom_corr", "knn_topk_dyn", "knn_select",
              "select_walk")
BATCH_ROT = 1e-4     # rad, each scenario against its single replay
BATCH_TRANS = 1e-3   # m

# the long golden gates (tests/test_golden_parity.py:22-46,72-145,186-194)
GOLDEN_F = 100
GOLDEN_EXACT_F = 30
GOLDEN_AZIMUTH = 600
GOLDEN_SEED = 7
GOLDEN_ODOM_GATE = 0.01      # m
GOLDEN_YAW_GATE = 0.2        # deg

# the offline command line (phase 8)
OUT_DIR = ROOT / "smoke_out"   # gitignored
CLI_SYNTH_F = 24
CLI_BAG_F = 16
CLI_BAG_AZIMUTH = 1800
CLI_BAG_SEED = 13
CLI_BAG_T0 = 100.0   # bag stamp of trajectory time 0
CLI_BAG_PATH = ("select_walk", "knn_topk", "odom_corr", "knn_topk_dyn",
                "knn_select")
CKPT_EVERY = 4
CKPT_SPLIT = 8       # frames before the interruption


def replay_config(name: str):
    from loam_tpu_torch.config import LoamConfig

    return dataclasses.replace(LoamConfig(), **REPLAYS[name][0])


def batch_config():
    """bench.py's _cfg(): full density (ring width 2048), tables 2^14 /
    2^15, search buckets 2^12, local-map caps 8192 / 16384, the hybrid
    cadence (map_exact_regather_every=5) without the drift re-gather."""
    from loam_tpu_torch.config import LoamConfig

    return dataclasses.replace(
        LoamConfig(), corner_table_size=1 << 14, surf_table_size=1 << 15,
        search_buckets=1 << 12, max_corner_from_map=8192,
        max_surf_from_map=16384, map_exact_knn=True,
        map_exact_regather_every=5, knn_regather_drift=0.0)


def golden_config(exact: bool):
    """tests/test_golden_parity.py's CFG (the cell-bucket map) or its
    CFG_EXACT with the hybrid cadence (map_exact_regather_every=5)."""
    from loam_tpu_torch.config import LoamConfig

    over = dict(ring_width=1024, corner_table_size=1 << 15,
                surf_table_size=1 << 17)
    if exact:
        over.update(max_corner_from_map=16384, max_surf_from_map=32768,
                    map_exact_regather_every=5)
    else:
        over.update(map_exact_knn=False)
    return dataclasses.replace(LoamConfig(), **over)


def imu_config():
    """The golden IMU configuration: rings of 1024, the cell-bucket map."""
    from loam_tpu_torch.config import LoamConfig

    return dataclasses.replace(LoamConfig(), ring_width=1024,
                               corner_table_size=1 << 15,
                               surf_table_size=1 << 17, map_exact_knn=False)


def imu_inputs(dev):
    """The golden IMU scenario on `dev`: (raw, mask, ImuStream windows,
    sweep stamps) as tensors, and the NumPy sequence of imu_sequence."""
    from loam_tpu_torch.imu import ImuStream

    seq = imu_sequence()
    raw, msk, imu_t, rpy, acc, t_scans, _ = seq
    stream = ImuStream(*(torch.tensor(a, device=dev)
                         for a in frame_windows(imu_t, rpy, acc, t_scans)))
    return (torch.tensor(raw, device=dev), torch.tensor(msk, device=dev),
            stream, torch.tensor(t_scans.astype(np.float32), device=dev)), seq


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of fn() between CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_BALLAST = None    # the matrix device_ms keeps the card busy with


def device_ms(fn, reps: int = 50) -> float:
    """Milliseconds a call of fn() takes on the device when the host is
    out of the way: reps calls are queued while the card is busy with a
    long matrix product, so they run back to back."""
    global _BALLAST
    fn()
    if _BALLAST is None:
        _BALLAST = torch.empty((8192, 8192), device="cuda").fill_(1e-3)
    ballast = _BALLAST
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.mm(ballast, ballast)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lattice(rng, shape, half: int = 2):
    """Coordinates on a 0.25 m lattice: many exactly equal distances."""
    return (rng.integers(-half, half + 1, size=shape) * 0.25).astype(
        np.float32)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least milliseconds the card could take, and what sets it."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / FP32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _compare(name, kernel_out, plain_out):
    """Every output of the kernel must equal the plain version's, bit for
    bit.  Returns the largest absolute difference found (0.0 to pass)."""
    err = 0.0
    for k, p in zip(kernel_out, plain_out):
        if k.dtype != p.dtype or not torch.equal(k, p):
            bad = int((k != p).sum())
            raise AssertionError(f"{name}: {bad} entries differ from the "
                                 f"plain version")
        err = max(err, float((k.double() - p.double()).abs().max()))
    return err


def make_sweeps():
    from loam_tpu_torch.io import synth

    world = synth.make_world(seed=SEED)
    poses = synth.straight_trajectory(FRAMES, speed=0.9, yaw_rate=0.1)
    poses = np.vstack([poses[:1], poses])[: FRAMES + 1]
    sweeps = [synth.simulate_sweep(world, poses[k], poses[k + 1],
                                   n_azimuth=N_AZIMUTH, seed=SEED + k)
              for k in range(FRAMES)]
    raw = np.stack([s[0] for s in sweeps]).astype(np.float32)
    return raw, np.stack([s[1] for s in sweeps])


def batch_sweeps():
    """bench.py's _data recipe with the port's io/synth: BATCH_B random
    worlds, speeds 0.6-1.4 m/s, yaw rates +-0.15 rad/s, BATCH_F
    full-density sweeps each.  Returns (raw (B, F, N, 3), mask (B, F, N),
    seconds)."""
    from loam_tpu_torch.io import synth

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    raws, msks = [], []
    for b in range(BATCH_B):
        world = synth.make_world(seed=int(rng.integers(1 << 30)))
        poses = synth.straight_trajectory(
            BATCH_F, speed=float(rng.uniform(0.6, 1.4)),
            yaw_rate=float(rng.uniform(-0.15, 0.15)))
        poses = np.vstack([poses[:1], poses])[: BATCH_F + 1]
        sweeps = [synth.simulate_sweep(world, poses[k], poses[k + 1],
                                       n_azimuth=N_AZIMUTH,
                                       seed=b * BATCH_F + k)
                  for k in range(BATCH_F)]
        raws.append(np.stack([x for x, _ in sweeps]).astype(np.float32))
        msks.append(np.stack([m for _, m in sweeps]))
    return np.stack(raws), np.stack(msks), time.perf_counter() - t0


def golden_sequence():
    """The 100-frame straight sequence of tests/test_golden_parity.py
    (_make_sequence("straight")), a NumPy copy."""
    from loam_tpu_torch.io import synth

    world = synth.make_world(seed=GOLDEN_SEED)
    poses = synth.straight_trajectory(GOLDEN_F, speed=0.9, yaw_rate=0.12)
    poses = np.vstack([poses[:1], poses])[: GOLDEN_F + 1]
    sweeps = [synth.simulate_sweep(world, poses[k], poses[k + 1],
                                   n_azimuth=GOLDEN_AZIMUTH,
                                   seed=GOLDEN_SEED + k)
              for k in range(GOLDEN_F)]
    return (np.stack([x for x, _ in sweeps]),
            np.stack([m for _, m in sweeps]))


def _library_knn(q, ref, k):
    """cdist + topk over the live queries and references."""
    return torch.cdist(q, ref).topk(k, dim=-1, largest=False)


def kernel_phase(dev, raw, msk, cfg, imu):
    """Each kernel vs its plain version at the replays' shapes.  Returns
    one row a kernel (its largest shape), with the other shapes' rows
    under "other_shapes"."""
    from loam_tpu_torch.ops.cuda import knn_topk as KN
    from loam_tpu_torch.ops.cuda import kselect as KS
    from loam_tpu_torch.ops.cuda import odom_corr as OC

    rng = np.random.default_rng(SEED)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = []

    def cloud(n, live, spread, B=1):
        pts = rng.uniform(-spread, spread, (B, n, 3)).astype(np.float32)
        pts[:, live:] = 0.0
        return torch.tensor(pts, device=dev)

    def add(name, counter, source, replaces, shapes):
        """shapes: the per-shape measurement dicts, largest last."""
        row = dict(name=name, counter=counter, route="cuda", source=source,
                   replaces=replaces, **shapes[-1])
        row["max_abs_err"] = max(s["max_abs_err"] for s in shapes)
        row["other_shapes"] = shapes[:-1]
        rows.append(row)

    def near(ref, live, Q, sigma):
        """Q queries (B, Q, 3) scattered around live references."""
        B = ref.shape[0]
        pick = torch.tensor(rng.integers(0, live, (B, Q)), device=dev)
        base = torch.gather(ref, 1, pick[..., None].expand(B, Q, 3))
        return (base + torch.tensor(rng.normal(0, sigma, (B, Q, 3)),
                                    device=dev)).float().contiguous()

    # ---- knn_topk k=1: the odometry 1-NN through its wrapper, as the
    # odometry calls it (a lattice cloud full of exact ties, then the
    # corner and surf shapes, the surf shape also for the batch of
    # BATCH_B scenarios), every output compared exactly
    shapes = []
    for B, Q, M, ties in ((1, 512, 4096, True), (1, 256, 2048, False),
                          (BATCH_B, 512, 16384, False),
                          (1, 512, 16384, False)):
        live = M * 2 // 3
        n_ref = torch.full((B,), live, **i32)
        n_q = torch.full((B,), Q, **i32)
        if ties:
            ref = torch.tensor(lattice(rng, (B, M, 3)), device=dev)
            q = torch.tensor(lattice(rng, (B, Q, 3)), device=dev)
        else:
            ref = cloud(M, live, 30.0, B)
            q = near(ref, live, Q, 0.2)
        t_lo, t_hi = KN.full_windows(B, Q, M, 256, 512, dev)
        run_k = lambda: KN.knn_topk(q, ref, n_ref, 1, tq=256, tm=512)
        run_p = lambda: KN.knn_topk_plain(q, ref, n_q, n_ref, 1, t_lo, t_hi,
                                          tq=256, tm=512)
        shapes.append(dict(
            shape=f"B={B},Q={Q},M={M},live={live},k=1"
                  + (",lattice" * ties),
            max_abs_err=_compare("knn_topk", run_k(), run_p()),
            ms=time_ms(run_k), device_ms=device_ms(run_k),
            plain_ms=time_ms(run_p),
            library_ms=time_ms(lambda: _library_knn(q, ref[:, :live], 1)),
            **bound(B * (12 * (Q + live) + 8 * Q), PAIR_OPS * B * Q * live)))
    add("knn_topk", "knn_topk", "loam_tpu_torch/csrc/knn_nearest.cu",
        "loam_tpu/ops/pallas/knn_topk.py:63", shapes)

    # ---- knn_topk_dyn with tile windows: the mapping 5-NN (margin 1 m)
    # and the hybrid cadence's 8-candidate gather (margin 2 m), every
    # output compared exactly.  First a lattice shape full of exact ties:
    # five live query blocks (the last with rows past n_q), one that sees
    # 3 references, one with an empty window, one whose window needs both
    # clamps, three dead blocks.
    def windowed(name, k, q, ref, n_q, n_ref_i, t_lo, t_hi, tq, tm, note=""):
        B, Q, M = q.shape[0], q.shape[1], ref.shape[1]
        nq_t = torch.full((B,), n_q, **i32)
        nr_t = torch.full((B,), n_ref_i, **i32)
        run_k = lambda: KN._launch(q, ref, nq_t, nr_t, k, t_lo, t_hi, tq, tm)
        run_p = lambda: KN.knn_topk_plain(q, ref, nq_t, nr_t, k, t_lo, t_hi,
                                          tq=tq, tm=tm)
        # references each live query block really scans
        blocks = -(-n_q // tq)
        seen = (torch.clamp(t_hi[:, :blocks].long() * tm, max=n_ref_i)
                - t_lo[:, :blocks].long().clamp(min=0) * tm).clamp(min=0)
        pairs = int(seen.sum()) * tq
        return dict(
            shape=f"B={B},Q={Q},M={M},live={n_q}x{n_ref_i},k={k},"
                  f"pairs={pairs}" + note,
            max_abs_err=_compare(name, run_k(), run_p()),
            ms=time_ms(run_k), device_ms=device_ms(run_k),
            plain_ms=time_ms(run_p),
            # materialises the live (n_q, n_ref) matrices: 1.2 GB a
            # scenario at the largest shape
            library_ms=time_ms(lambda: _library_knn(
                q[:, :n_q], ref[:, :n_ref_i], k), reps=5),
            **bound(B * (12 * (n_q + n_ref_i) + 8 * k * blocks * tq),
                    PAIR_OPS * pairs))

    def sorted_cloud(B, Q, M, n_q, n_ref_i, margin, tq, tm):
        """B slabs of sorted references with queries around them, and
        each scenario's tile windows."""
        half = np.array([60.0, 20.0, 5.0])
        refp = np.zeros((B, M, 3), np.float32)
        qp = np.zeros((B, Q, 3), np.float32)
        for b in range(B):
            ref_np = rng.uniform(-half, half, (n_ref_i, 3)).astype(np.float32)
            ref_np = ref_np[np.argsort(ref_np[:, 0], kind="stable")]
            refp[b, :n_ref_i] = ref_np
            q_np = ref_np[rng.integers(0, n_ref_i, n_q)] + rng.normal(
                0, 0.3, (n_q, 3))
            qp[b, :n_q] = q_np[np.argsort(q_np[:, 0], kind="stable")]
        q = torch.tensor(qp, device=dev)
        ref = torch.tensor(refp, device=dev)
        mask = torch.arange(M, device=dev) < n_ref_i
        t_lo, t_hi = KN.tile_windows(
            q[..., 0], torch.full((B,), n_q, **i32), ref[..., 0],
            mask.expand(B, M), tq, tm, margin + 1e-3)
        return q, ref, t_lo.contiguous(), t_hi.contiguous()

    tq, tm = 256, 512
    for k, margin, name in ((5, 1.0, "knn_topk_dyn"),
                            (8, 2.0, "knn_topk_dyn_k8")):
        Q, M = 8 * tq, 8 * tm
        t_lo = torch.tensor([[0, 7, 3, 2, -1, 0, 0, 0]], **i32)
        t_hi = torch.tensor([[8, 8, 3, 5, 99, 8, 8, 8]], **i32)
        shapes = [windowed(
            name, k, torch.tensor(lattice(rng, (1, Q, 3)), device=dev),
            torch.tensor(lattice(rng, (1, M, 3)), device=dev),
            4 * tq + tq // 2 + 1, 7 * tm + 3, t_lo, t_hi, tq, tm, ",lattice")]
        # (scenarios, Q, M, live queries, live references); K=8 also at
        # the batch's BATCH_B scenarios
        sizes = ((1, 2048, 32768, 1500, 25000),
                 (BATCH_B, 8192, 65536, 6000, 50000),
                 (1, 8192, 65536, 6000, 50000))
        for B, Q, M, n_q, n_ref_i in sizes if k == 5 else sizes[1:]:
            if k == 5 and B > 1:
                continue
            q, ref, t_lo, t_hi = sorted_cloud(B, Q, M, n_q, n_ref_i,
                                              margin, tq, tm)
            shapes.append(windowed(name, k, q, ref, n_q, n_ref_i, t_lo,
                                   t_hi, tq, tm))
        add(name, "knn_topk_dyn", "loam_tpu_torch/csrc/knn_topk.cu",
            "loam_tpu/ops/pallas/knn_topk.py:133", shapes)

    # ---- odom_corr: surf walks on a lattice cloud with locally unsorted
    # rings (exact ties within and across the two sides), then corner and
    # surf walks on a ring-sorted cloud, the surf walks also for the
    # batch of BATCH_B scenarios; every output compared exactly
    shapes = []
    for B, Q, M, surf, ties in ((1, 512, 4096, True, True),
                                (1, 256, 2048, False, False),
                                (BATCH_B, 512, 16384, True, False),
                                (1, 512, 16384, True, False)):
        live = M * 2 // 3
        rings = np.zeros((B, M), np.int32)
        rings[:, :live] = np.sort(rng.integers(0, 16, (B, live)), -1)
        j1 = torch.tensor(rng.integers(-1, live, (B, Q)), **i32)
        if ties:
            rings[:, :live] = np.clip(
                rings[:, :live] + rng.integers(-2, 3, (B, live)), 0, 15)
            ref = torch.tensor(lattice(rng, (B, M, 3)), device=dev)
            q = torch.tensor(lattice(rng, (B, Q, 3)), device=dev)
        else:
            ref = cloud(M, live, 30.0, B)
            base = torch.gather(ref, 1, j1.clamp(min=0).long()[..., None]
                                .expand(B, Q, 3))
            q = (base + torch.tensor(rng.normal(0, 0.3, (B, Q, 3)),
                                     device=dev)).float().contiguous()
        ring_t = torch.tensor(rings, device=dev)
        n_q = torch.full((B,), Q * 3 // 4, **i32)
        n_ref = torch.full((B,), live, **i32)
        args = (q, ref, ring_t, j1, n_q, n_ref)
        kw = dict(surf=surf, window=cfg.ring_window, truncate=True)
        run_k = lambda: OC._launch(*args, **kw)
        run_p = lambda: OC.odom_corr_plain(*args, **kw)
        up, dn, _, _ = OC.walk_masks(ring_t, j1, n_q, n_ref,
                                     window=cfg.ring_window, truncate=True)
        visited = int(up.sum()) + int(dn.sum())
        shapes.append(dict(
            shape=f"B={B},Q={Q},M={M},live={live},"
                  f"{'surf' if surf else 'corner'},visited={visited}"
                  + (",lattice" * ties),
            max_abs_err=_compare("odom_corr", run_k(), run_p()),
            ms=time_ms(run_k), device_ms=device_ms(run_k),
            plain_ms=time_ms(run_p), library_ms=None,
            # + a ring compare per visited point
            **bound(B * (12 * Q + 16 * live + 4 * Q + 16 * Q),
                    (PAIR_OPS + 1) * visited)))
    add("odom_corr", "odom_corr", "loam_tpu_torch/csrc/odom_corr.cu",
        "loam_tpu/ops/pallas/odom_corr.py:65", shapes)

    rows.append(select_walk_row(dev, raw, msk, cfg, imu))

    # ---- kselect, every output compared exactly: lattice candidates
    # (exact ties in every row), the hybrid re-rank (C=8), the cell
    # re-rank (C=24), the 27-cell gather chunk at k=1 (distances and one
    # round: what the other 23 rounds of the next shape cost) and at k=24
    # (C=864: ~60% valid, the second half of every row's cells
    # duplicated, some rows with fewer than k valid); the hybrid re-rank
    # also at the batch's BATCH_B x 8192 rows
    shapes = []
    for Q, C, k, ties in ((8200, 24, 5, True), (1024, 864, 24, True),
                          (8192, 8, 5, False), (BATCH_B * 8192, 8, 5, False),
                          (8192, 24, 5, False), (2048, 864, 1, False),
                          (2048, 864, 24, False)):
        if ties:
            q_np = lattice(rng, (Q, 3))
            cand_np = lattice(rng, (Q, C, 3), half=3)
        else:
            q_np = rng.uniform(-30, 30, (Q, 3)).astype(np.float32)
            cand_np = (q_np[:, None, :]
                       + rng.normal(0, 0.8, (Q, C, 3))).astype(np.float32)
        valid_np = rng.uniform(size=(Q, C)) < 0.6
        if C == 864:
            cand_np[:, C // 2:] = cand_np[:, :C // 2]
            valid_np[::7, max(k - 4, 0):] = False   # fewer than k valid
            valid_np[::64] = False                  # none at all
        cand = torch.tensor(cand_np, device=dev)
        valid = torch.tensor(valid_np, device=dev)
        q = torch.tensor(q_np, device=dev)
        run_k = lambda: KS._launch(cand, valid, q, k)
        run_p = lambda: KS.knn_select_plain(cand, valid, q, k)

        def run_lib():
            d2, idx = KS.masked_sq_dists(cand, valid, q).topk(
                k, dim=1, largest=False)
            return torch.gather(cand, 1, idx[..., None].expand(-1, -1, 3)), d2

        n_valid = int(valid.sum())
        shapes.append(dict(
            shape=f"Q={Q},C={C},k={k},valid={n_valid}" + (",lattice" * ties),
            max_abs_err=_compare("kselect", run_k(), run_p()),
            ms=time_ms(run_k), device_ms=device_ms(run_k),
            plain_ms=time_ms(run_p), library_ms=time_ms(run_lib),
            # 8 flops a valid candidate, then k scans of C compares
            **bound(Q * C * 13 + Q * 12 + Q * k * 16,
                    8 * n_valid + Q * C * k)))
    add("kselect", "knn_select", "loam_tpu_torch/csrc/kselect.cu",
        "loam_tpu/ops/pallas/kselect.py:33", shapes)
    torch.cuda.synchronize()
    return rows


def select_walk_row(dev, raw, msk, cfg, imu):
    """select_walk at one frame's rings (online use at 10 Hz), bench.py's
    batch (B=8 scenarios x 17 frames, filled by tiling the replay's rings),
    every ring of the IMU replay (imu_inputs: deskewed, rings of 1024) and
    every ring of the replay (the row's own shape); every output compared
    exactly.  The serial NumPy walk of tests/torch_parity counts what
    these inputs need: candidates walked (meta words read), picks, and
    the kernel's rounds (32-candidate chunks plus picks)."""
    from loam_tpu_torch import frontend, pipeline
    from loam_tpu_torch.ops import features as FT
    from loam_tpu_torch.ops.cuda import select_walk as SW
    from torch_parity import serial_walk, walk_kwargs

    def walk_inputs(sweep, cfg):
        curv, gap, pre, counts = FT.selection_inputs(sweep, cfg)
        W = cfg.ring_width
        cm, fm = FT.walk_meta(curv.reshape(-1, W), gap.reshape(-1, W),
                              counts.reshape(-1), cfg)
        pre = pre.reshape(-1, W)
        kw = walk_kwargs(cfg, W)
        _, need = serial_walk(cm.cpu().numpy(), fm.cpu().numpy(),
                              pre.cpu().numpy(), **kw)
        return cm, fm, pre, kw, need

    replay_rings = walk_inputs(frontend.ingest_sweep(
        torch.tensor(raw, device=dev), torch.tensor(msk, device=dev), cfg),
        cfg)
    (iraw, imsk, stream, t_scans), _ = imu
    imu_rings = walk_inputs(pipeline.ingest_frames(
        iraw, imsk, imu_config(), stream, t_scans)[0], imu_config())
    n_rings, n_imu = replay_rings[0].shape[0], imu_rings[0].shape[0]
    shapes = []
    for rings, B, R, note in ((replay_rings, 1, cfg.n_scans, ""),
                              (replay_rings, 8, 17 * cfg.n_scans, ""),
                              (imu_rings, 1, n_imu, ",imu"),
                              (replay_rings, 1, n_rings, "")):
        cm_all, fm_all, pre, kw, need = rings
        W = kw["W"]
        idx = torch.arange(B * R, device=dev) % cm_all.shape[0]
        cm = cm_all[idx].reshape(B, R, -1).contiguous()
        fm = fm_all[idx].reshape(B, R, -1).contiguous()
        p0 = SW.pack_bits(pre[idx]).reshape(B, R, -1)
        n = {k: int(v[idx.cpu().numpy()].sum()) for k, v in need.items()}
        max_rounds = int(need["rounds"][idx.cpu().numpy()].max())
        run_k = lambda: SW._launch(cm, fm, p0, **kw)
        run_p = lambda: SW.select_walk_plain(cm, fm, p0, **kw)
        shapes.append(dict(
            shape=f"B={B},R={R},W={W},walked={n['walked']},"
                  f"picks={n['picks']},rounds={n['rounds']},"
                  f"max_rounds={max_rounds}" + note,
            max_abs_err=_compare("select_walk", run_k(), run_p()),
            ms=time_ms(run_k), device_ms=device_ms(run_k),
            plain_ms=time_ms(run_p, reps=5), library_ms=None,
            # 4 bytes a walked meta word and a uint32 word of each
            # bit-field (pre-picked in, four out: the walk needs no more,
            # whatever the wrapper's int64 holds); about 20 integer
            # operations a walked candidate
            **bound(4 * n["walked"] + 5 * 4 * B * R * (W // 32),
                    20 * n["walked"])))
    torch.cuda.synchronize()
    return dict(name="select_walk", counter="select_walk", route="cuda",
                source="loam_tpu_torch/csrc/select_walk.cu",
                replaces="loam_tpu/ops/pallas/select_walk.py:81",
                **{**shapes[-1], "max_abs_err": max(
                    s["max_abs_err"] for s in shapes)},
                other_shapes=shapes[:-1])


def counted_replay(name, required, forbidden, warm_up, run):
    """warm_up() (library handles, allocator; uncounted), then run() with
    every launch count zeroed just before it and read just after it.
    Returns (outputs, launch counts, seconds).  Raises when a kernel of
    this replay's path was not launched, or one outside it was."""
    from loam_tpu_torch.ops.cuda import knn_topk as KN
    from loam_tpu_torch.ops.cuda import kselect as KS
    from loam_tpu_torch.ops.cuda import odom_corr as OC
    from loam_tpu_torch.ops.cuda import select_walk as SW

    warm_up()
    torch.cuda.synchronize()
    wrappers = {"knn_topk": KN.knn_topk, "knn_topk_dyn": KN.knn_topk_dyn,
                "odom_corr": OC.odom_corr, "select_walk": SW.select_walk,
                "knn_select": KS.knn_select}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in wrappers.items()}
    missing = [n for n in required if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{name} replay never launched {missing}")
    stray = [n for n in forbidden if counts[n] > 0]
    if stray:
        raise AssertionError(f"{name} replay launched {stray}")
    return outs, counts, seconds


def replay(name, raw_t, msk_t):
    """One replay on the card after a 3-frame warm-up."""
    from loam_tpu_torch import pipeline

    cfg = replay_config(name)
    _, required, forbidden = REPLAYS[name]
    return counted_replay(
        name, required, forbidden,
        lambda: pipeline.replay_sweeps(raw_t[:3], msk_t[:3], cfg),
        lambda: pipeline.replay_sweeps(raw_t, msk_t, cfg))


def imu_samples(pose_fn, t_end: float):
    """The noise-free 200 Hz IMU stream of a trajectory from t=0 to
    t_end: orientation (pitch, yaw, roll) straight from the trajectory,
    body-frame coordinate acceleration from central differences (the
    post-gravity-removal quantities of scanRegistration.cpp:643-647)."""
    from loam_tpu_torch.io import synth

    imu_t = np.arange(0.0, t_end, 1.0 / IMU_RATE)
    h = 1e-3
    rpy = np.zeros((imu_t.shape[0], 3))
    acc = np.zeros((imu_t.shape[0], 3))
    for i, t in enumerate(imu_t):
        p = pose_fn(t)
        rpy[i] = p[:3]  # (pitch, yaw, roll) == (rx, ry, rz)
        a_w = (pose_fn(t + h)[3:6] - 2 * p[3:6] + pose_fn(t - h)[3:6]) / h**2
        R, _ = synth._pose_matrix(p)
        acc[i] = R.T @ a_w
    return imu_t, rpy, acc


def imu_sequence():
    """The raw sweeps of the golden IMU scenario and the noise-free IMU
    stream of its trajectory (imu_samples).  A NumPy copy of
    tests/test_golden_parity_imu._make_imu_sequence."""
    from loam_tpu_torch.io import synth

    world = synth.make_world(seed=IMU_SEED)
    pose_fn = synth.oscillating_trajectory()
    t_scans = IMU_T0 + 0.1 * np.arange(IMU_FRAMES)
    sweeps = [synth.simulate_sweep_traj(world, pose_fn, t0=float(t),
                                        n_azimuth=IMU_AZIMUTH,
                                        seed=IMU_SEED + k)
              for k, t in enumerate(t_scans)]
    raw = np.stack([s[0] for s in sweeps])
    msk = np.stack([s[1] for s in sweeps])
    imu_t, rpy, acc = imu_samples(pose_fn, float(t_scans[-1]) + 0.25)
    return (raw, msk, imu_t, rpy.astype(np.float32), acc.astype(np.float32),
            t_scans, pose_fn)


def frame_windows(imu_t, rpy, acc, t_scans):
    """Per-frame windows (t, rpy, acc, mask; leading frame axis) over the
    samples the oracle is fed, from t_scan - IMU_LEAD to t_scan +
    IMU_HORIZON, valid samples first.  A NumPy copy of
    tests/test_golden_parity_imu._frame_windows."""
    F = t_scans.shape[0]
    t_w = np.zeros((F, IMU_CAP), np.float32)
    r_w = np.zeros((F, IMU_CAP, 3), np.float32)
    a_w = np.zeros((F, IMU_CAP, 3), np.float32)
    m_w = np.zeros((F, IMU_CAP), bool)
    for f, t0 in enumerate(t_scans):
        sel = np.nonzero((imu_t >= t0 - IMU_LEAD)
                         & (imu_t <= t0 + IMU_HORIZON))[0]
        n = sel.shape[0]
        if not 0 < n <= IMU_CAP:
            raise AssertionError(f"frame {f}: {n} IMU samples in a window "
                                 f"of {IMU_CAP}")
        t_w[f, :n] = imu_t[sel]
        r_w[f, :n] = rpy[sel]
        a_w[f, :n] = acc[sel]
        m_w[f, :n] = True
    return t_w, r_w, a_w, m_w


def imu_phase(dev, card: str, imu):
    """The golden IMU scenario (imu_inputs) replayed whole on the card
    with its streams, held to tests/test_golden_parity_imu.py's gates
    against the NumPy oracle.  Returns the replay's launch counts."""
    from golden.pipeline import run_pipeline_imu
    from loam_tpu_torch import metrics, pipeline

    (raw_t, msk_t, stream, t_t), seq = imu
    raw, msk, imu_t, rpy, acc, t_scans, pose_fn = seq
    oracle = run_pipeline_imu(raw, msk, imu_t, rpy, acc, t_scans,
                              feed_horizon=IMU_HORIZON)
    cfg = imu_config()
    outs, counts, seconds = counted_replay(
        "imu", *IMU_PATH,
        lambda: pipeline.replay_sweeps(raw_t[:3], msk_t[:3], cfg,
                                       stream.map(lambda a: a[:3]), t_t[:3]),
        lambda: pipeline.replay_sweeps(raw_t, msk_t, cfg, stream, t_t))
    odom = outs.pose_odom.cpu().numpy()
    est = outs.pose_integrated.cpu().numpy()
    if not (np.isfinite(est).all() and np.isfinite(odom).all()):
        raise AssertionError("imu replay: non-finite poses")
    ate_odom = metrics.ate_rmse(odom[:, 3:6], oracle["odom"][:, 3:6])
    ate_int = metrics.ate_rmse(est[:, 3:6], oracle["integrated"][:, 3:6])
    attitude = float(np.degrees(np.abs(
        est[:, [0, 2]] - oracle["integrated"][:, [0, 2]]).max()))
    gt = np.stack([pose_fn(t + 0.1)[3:6] for t in t_scans])
    ate_gt = metrics.ate_rmse(est[:, 3:6], gt)
    plain = pipeline.replay_sweeps(raw_t, msk_t, cfg)
    moved = float(np.linalg.norm(
        est[:, 3:6] - plain.pose_integrated.cpu().numpy()[:, 3:6],
        axis=1).max())
    print(f"replay imu: {IMU_FRAMES} frames in {seconds:.3f} s = "
          f"{IMU_FRAMES / seconds:.2f} frames/s; ATE vs golden oracle "
          f"odometry {100 * ate_odom:.3f} cm, integrated {100 * ate_int:.3f}"
          f" cm; pitch/roll gap {attitude:.4f} deg; ATE vs ground truth "
          f"{ate_gt:.4f} m; the no-IMU rerun differs by {moved:.4f} m; "
          f"launches {counts} [{card}]", flush=True)
    gates = ((ate_odom < IMU_ODOM_GATE, f"odometry ATE {ate_odom:.4f} m"),
             (ate_int < ATE_GATE, f"integrated ATE {ate_int:.4f} m"),
             (attitude < IMU_ATTITUDE_GATE, f"pitch/roll gap {attitude} deg"),
             (ate_gt < IMU_GT_GATE, f"ground-truth ATE {ate_gt:.4f} m"),
             (moved > IMU_MOVES, f"the IMU moved the trajectory {moved} m"))
    failed = [what for ok, what in gates if not ok]
    if failed:
        raise AssertionError(f"imu replay failed its gates: {failed}")
    return counts


def mapping_host_reads(run):
    """run(), counting the host reads of each mapping frame: scalar
    reads of a device tensor (aten::_local_scalar_dense, what bool() and
    int() of a tensor call) that torch.profiler sees on the CPU inside
    mapping.mapping_step.  Returns (run()'s result, the counts in frame
    order)."""
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu_torch import mapping

    step = mapping.mapping_step
    reads = []

    def counted(*args, **kw):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = step(*args, **kw)
        reads.append(sum(e.count for e in prof.key_averages()
                         if e.key == "aten::_local_scalar_dense"))
        return out

    mapping.mapping_step = counted
    try:
        return run(), reads
    finally:
        mapping.mapping_step = step


def batch_phase(dev, card: str):
    """bench.py's workload through batched_replay on the card, held to
    each scenario's own single-scenario replay.  Returns the batch's
    launch counts."""
    from loam_tpu_torch import pipeline
    from loam_tpu_torch.parallel import replay as PR

    cfg = batch_config()
    raw, msk, secs = batch_sweeps()
    print(f"batch: {BATCH_B} scenarios x {BATCH_F} sweeps of {N_AZIMUTH} "
          f"azimuths made in {secs:.1f} s on the host, all unique",
          flush=True)
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    torch.cuda.reset_peak_memory_stats()
    outs, counts, seconds = counted_replay(
        "batch", BATCH_PATH, (),
        lambda: PR.batched_replay(raw_t[:, :3], msk_t[:, :3], cfg),
        lambda: PR.batched_replay(raw_t, msk_t, cfg))
    peak = torch.cuda.max_memory_allocated() / 2**20
    singles, single_counts, single_s = [], {}, 0.0
    for b in range(BATCH_B):
        one, c, t = counted_replay(
            f"batch scenario {b}", BATCH_PATH, (), lambda: None,
            lambda: pipeline.replay_sweeps(raw_t[b], msk_t[b], cfg))
        singles.append(one)
        single_s += t
        for n, v in c.items():
            single_counts[n] = single_counts.get(n, 0) + v
    # host reads of each mapping frame: the batch's, and the most any
    # single replay makes at that frame
    _, batch_reads = mapping_host_reads(
        lambda: PR.batched_replay(raw_t, msk_t, cfg))
    single_reads = np.max([mapping_host_reads(
        lambda: pipeline.replay_sweeps(raw_t[b], msk_t[b], cfg))[1]
        for b in range(BATCH_B)], 0).tolist()
    failed, gap = [], [0.0, 0.0]
    for b, one in enumerate(singles):
        got = {n: getattr(outs, n)[b].cpu().numpy() for n in
               ("pose_odom", "pose_aft", "pose_integrated", "mapped")}
        if not np.isfinite(got["pose_integrated"]).all():
            failed.append(f"scenario {b}: non-finite poses")
        if not np.array_equal(got["mapped"], one.mapped.cpu().numpy()):
            failed.append(f"scenario {b}: cadence differs from its single "
                          "replay")
        for n in ("pose_odom", "pose_aft", "pose_integrated"):
            d = np.abs(got[n].astype(np.float64)
                       - getattr(one, n).cpu().numpy())
            rot, trans = float(d[:, :3].max()), float(d[:, 3:].max())
            gap = [max(gap[0], rot), max(gap[1], trans)]
            if not (rot < BATCH_ROT and trans < BATCH_TRANS):
                failed.append(f"scenario {b} {n}: {rot} rad, {trans} m "
                              "from its single replay")
    frames = BATCH_B * BATCH_F
    print(f"replay batch: {BATCH_B} x {BATCH_F} frames in {seconds:.3f} s "
          f"= {frames / seconds:.2f} frames/s batched; the {BATCH_B} "
          f"single replays {frames / single_s:.2f} frames/s "
          f"({single_s:.3f} s); largest pose gap to them {gap[0]:.3g} rad, "
          f"{gap[1]:.3g} m; peak device memory {peak:.1f} MiB; host "
          f"reads a mapping frame batched {batch_reads}, the most of a "
          f"single replay {single_reads}; launches batched {counts}, the "
          f"single replays together {single_counts} [{card}]", flush=True)
    if not counts["knn_topk"] < single_counts["knn_topk"]:
        failed.append(f"knn_topk launches {counts['knn_topk']} batched, "
                      f"{single_counts['knn_topk']} single")
    if any(b > s for b, s in zip(batch_reads, single_reads)):
        failed.append(f"host reads a mapping frame {batch_reads} batched, "
                      f"at most {single_reads} single")
    if failed:
        raise AssertionError(f"batch replay failed its gates: {failed}")
    return counts


def golden_phase(dev, card: str):
    """The long golden gates of tests/test_golden_parity.py on the card.
    Returns the launch counts of its two replays."""
    from golden.pipeline import run_pipeline
    from loam_tpu_torch import metrics, pipeline

    raw, msk = golden_sequence()
    t0 = time.perf_counter()
    oracle = run_pipeline(raw, msk)
    print(f"golden: {GOLDEN_F} sweeps of {GOLDEN_AZIMUTH} azimuths, the "
          f"oracle in {time.perf_counter() - t0:.1f} s on the host",
          flush=True)
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    cfg = golden_config(exact=False)
    outs, cells, seconds = counted_replay(
        "golden", ("knn_topk", "odom_corr", "select_walk", "knn_select"),
        ("knn_topk_dyn",),
        lambda: pipeline.replay_sweeps(raw_t[:3], msk_t[:3], cfg),
        lambda: pipeline.replay_sweeps(raw_t, msk_t, cfg))
    pose = {n: getattr(outs, n).cpu().numpy()
            for n in ("pose_odom", "pose_aft", "pose_integrated")}
    ate = {n: metrics.ate_rmse(pose[n][:, 3:6], oracle[key][:, 3:6])
           for n, key in (("pose_odom", "odom"), ("pose_aft", "aft"),
                          ("pose_integrated", "integrated"))}
    yaw = float(np.degrees(np.abs(pose["pose_integrated"][:, 1]
                                  - oracle["integrated"][:, 1]).max()))
    cadence = np.array_equal(outs.mapped.cpu().numpy(), oracle["mapped"])
    print(f"replay golden: {GOLDEN_F} frames in {seconds:.3f} s = "
          f"{GOLDEN_F / seconds:.2f} frames/s; ATE vs golden oracle "
          f"odometry {100 * ate['pose_odom']:.4f} cm, integrated "
          f"{100 * ate['pose_integrated']:.4f} cm, aft-mapped "
          f"{100 * ate['pose_aft']:.4f} cm; yaw gap {yaw:.4f} deg; mapping "
          f"cadence equal: {cadence}; launches {cells} [{card}]", flush=True)

    cfg = golden_config(exact=True)
    n = GOLDEN_EXACT_F
    hyb, hybrid, seconds = counted_replay(
        "golden hybrid", ("knn_topk", "odom_corr", "select_walk",
                          "knn_topk_dyn", "knn_select"), (),
        lambda: pipeline.replay_sweeps(raw_t[:3], msk_t[:3], cfg),
        lambda: pipeline.replay_sweeps(raw_t[:n], msk_t[:n], cfg))
    est = hyb.pose_integrated.cpu().numpy()
    ate_h = metrics.ate_rmse(est[:, 3:6], oracle["integrated"][:n, 3:6])
    print(f"replay golden hybrid: {n} frames in {seconds:.3f} s = "
          f"{n / seconds:.2f} frames/s; integrated ATE vs golden oracle "
          f"{100 * ate_h:.4f} cm; launches {hybrid} [{card}]", flush=True)

    finite = all(np.isfinite(p).all() for p in pose.values()) \
        and np.isfinite(est).all()
    gates = ((finite, "non-finite poses"),
             (ate["pose_odom"] < GOLDEN_ODOM_GATE,
              f"odometry ATE {ate['pose_odom']:.4f} m"),
             (ate["pose_integrated"] < ATE_GATE,
              f"integrated ATE {ate['pose_integrated']:.4f} m"),
             (ate["pose_aft"] < ATE_GATE,
              f"aft-mapped ATE {ate['pose_aft']:.4f} m"),
             (cadence, "mapping cadence differs from the oracle"),
             (yaw < GOLDEN_YAW_GATE, f"yaw gap {yaw} deg"),
             (ate_h < ATE_GATE, f"hybrid integrated ATE {ate_h:.4f} m"))
    failed = [what for ok, what in gates if not ok]
    if failed:
        raise AssertionError(f"golden replays failed their gates: {failed}")
    return cells, hybrid


def cli_verdict(stdout: str) -> dict:
    """The golden_compare verdict line the CLI printed."""
    found = [json.loads(line)["golden_compare"]
             for line in stdout.splitlines()
             if line.startswith('{"golden_compare"')]
    if len(found) != 1:
        raise AssertionError(f"no golden_compare verdict in:\n{stdout}")
    return found[0]


def cli_timing(stdout: str):
    """The --report-timing lines and the replay's seconds."""
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith(("stage ", "replay "))]
    replay = [ln.split() for ln in lines if ln.startswith("replay ")]
    if len(replay) != 1:
        raise AssertionError(f"no replay timing in:\n{stdout}")
    return lines, float(replay[0][2]) / 1e3     # one replay: its mean ms


def check_cli_outputs(out: Path, frames: int, cfg) -> tuple[int, int]:
    """Three TUM files of `frames` finite poses, a map PLY with points,
    and under clouds/ the files of the cadence rule: a registered cloud
    every mapping frame, a surround cloud at each chunk's last frame.
    Returns (map points, cloud files)."""
    from loam_tpu_torch.io import export
    from loam_tpu_torch.pipeline import mapping_frame

    for name in ("odom", "aft_mapped", "integrated"):
        t, pos, quat = export.load_trajectory_tum(str(out / f"{name}.tum"))
        if t.shape != (frames,) or not (np.isfinite(pos).all()
                                        and np.isfinite(quat).all()):
            raise AssertionError(f"{out}/{name}.tum: {t.shape[0]} poses, "
                                 f"finite: {np.isfinite(pos).all()}")
    n_map = export.load_cloud_ply(str(out / "map_surround.ply")).shape[0]
    if n_map <= 0:
        raise AssertionError(f"{out}/map_surround.ply holds no point")
    chunk = cfg.map_frame_num * (cfg.skip_frame_num + 1)
    want = sorted(
        [f"registered_{k:04d}.ply" for k in range(frames)
         if mapping_frame(k, cfg)]
        + [f"surround_{min(s + chunk, frames) - 1:04d}.ply"
           for s in range(0, frames, chunk)])
    got = sorted(p.name for p in (out / "clouds").iterdir())
    if got != want:
        raise AssertionError(f"{out}/clouds holds {got}, the cadence rule "
                             f"gives {want}")
    return n_map, len(got)


def cli_synthetic_phase(card: str) -> None:
    """`python -m loam_tpu_torch --synthetic 24` with the cloud streams,
    the golden comparison and the timing report, as a subprocess."""
    from loam_tpu_torch.config import LoamConfig

    out = OUT_DIR / "cli_synth"
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "loam_tpu_torch", "--synthetic",
           str(CLI_SYNTH_F), "--out-dir", str(out), "--stream-clouds",
           "--golden-compare", "--report-timing"]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(
            f"{' '.join(cmd[1:])} exited {done.returncode}:\n"
            f"{done.stdout[-3000:]}\n{done.stderr[-5000:]}")
    verdict = cli_verdict(done.stdout)
    timing, replay_s = cli_timing(done.stdout)
    n_map, n_clouds = check_cli_outputs(out, CLI_SYNTH_F, LoamConfig())
    for line in timing:
        print(f"cli synthetic timing: {line}", flush=True)
    print(f"cli synthetic: {CLI_SYNTH_F} sweeps of 900 azimuths, replay "
          f"{replay_s:.3f} s = {CLI_SYNTH_F / replay_s:.2f} frames/s (the "
          f"first replay of its process); ATE vs golden oracle odometry "
          f"{verdict['ate_odom_cm']} cm, aft-mapped {verdict['ate_aft_cm']}"
          f" cm, integrated {verdict['ate_integrated_cm']} cm, pass "
          f"{verdict['pass']}; {n_map} map points, {n_clouds} cloud files; "
          f"the command took {seconds:.1f} s [{card}]", flush=True)
    if not verdict["pass"]:
        raise AssertionError(f"cli synthetic run failed its gate: {verdict}")


def write_cli_bag(path: str) -> float:
    """A bag of CLI_BAG_F full-density sweeps along the oscillating
    trajectory (the valid points, firing order) and its 200 Hz IMU
    stream as raw sensor_msgs/Imu messages: the quaternion of (roll,
    pitch, yaw) and the velodyne-frame acceleration that imu_from_raw's
    gravity removal and axis swap turn back into the trajectory's.
    Returns the host seconds it took."""
    from loam_tpu_torch.io import synth
    from torch_parity import raw_imu, rpy_to_quat, write_sweep_bag

    t0 = time.perf_counter()
    world = synth.make_world(seed=CLI_BAG_SEED)
    pose_fn = synth.oscillating_trajectory()
    t_scans = IMU_T0 + 0.1 * np.arange(CLI_BAG_F)
    sweeps = [synth.simulate_sweep_traj(world, pose_fn, t0=float(t),
                                        n_azimuth=CLI_BAG_AZIMUTH,
                                        seed=CLI_BAG_SEED + k)
              for k, t in enumerate(t_scans)]
    imu_t, pyr, acc = imu_samples(pose_fn, float(t_scans[-1]) + 0.25)
    rpy, acc_velodyne = raw_imu(pyr, acc)
    write_sweep_bag(path, sweeps, CLI_BAG_T0 + t_scans,
                    (CLI_BAG_T0 + imu_t, rpy_to_quat(rpy), acc_velodyne))
    return time.perf_counter() - t0


def cli_bag_phase(dev, card: str):
    """cli.main over the IMU bag in this process, its launches counted,
    held to a replay_sweeps of the same loaded arrays and windows.
    Returns (launch counts, the replay's inputs on the card)."""
    from loam_tpu_torch import cli, pipeline
    from loam_tpu_torch.io import export
    from loam_tpu_torch.utils import tracing

    out = OUT_DIR / "cli_bag"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    bag = str(out / "oscillating.bag")
    made_s = write_cli_bag(bag)
    argv = ["--bag", bag, "--skip", "0", "--knn-cadence", "fast",
            "--stream-clouds", "--golden-compare", "--report-timing",
            "--out-dir", str(out)]
    tracing.reset()
    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            return cli.main(argv)

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # by the earlier phases
    rc, counts, seconds = counted_replay("cli bag", CLI_BAG_PATH, (),
                                         lambda: None, run)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    stdout = buf.getvalue()
    print(stdout, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"cli bag run returned {rc}")
    verdict = cli_verdict(stdout)
    _, replay_s = cli_timing(stdout)

    # the same loaded arrays and IMU windows through replay_sweeps
    args = cli.build_parser().parse_args(argv)
    cfg = cli._config(args)
    t0 = time.perf_counter()
    raw, msk, stamps, imu = cli._load_data(args, cfg)
    load_s = time.perf_counter() - t0
    if imu is None or raw.shape[0] != CLI_BAG_F:
        raise AssertionError(f"the bag gave {raw.shape[0]} sweeps, "
                             f"IMU: {imu is not None}")
    t, rpy, acc = imu
    base = stamps[0]
    streams = cli._window_imu(t - base, rpy, acc, stamps - base, cfg,
                              device=dev)
    t_scans = torch.as_tensor(stamps - base, dtype=torch.float32,
                              device=dev)
    ref = pipeline.replay_sweeps(raw, msk, cfg, streams, t_scans,
                                 device=dev)
    export.save_trajectory_tum(str(out / "in_process.tum"), stamps,
                               ref.pose_integrated.cpu().numpy())
    _, pos_cli, _ = export.load_trajectory_tum(str(out / "integrated.tum"))
    _, pos_ref, _ = export.load_trajectory_tum(str(out / "in_process.tum"))
    same = (out / "integrated.tum").read_bytes() == \
        (out / "in_process.tum").read_bytes()
    n_map, n_clouds = check_cli_outputs(out, CLI_BAG_F, cfg)
    print(f"cli bag: {CLI_BAG_F} sweeps of {CLI_BAG_AZIMUTH} azimuths "
          f"({int(msk.sum())} points) and {t.shape[0]} IMU messages, the "
          f"bag written in {made_s:.2f} s and loaded in {load_s:.3f} s on "
          f"the host; replay {replay_s:.3f} s = {CLI_BAG_F / replay_s:.2f} "
          f"frames/s, cli.main {seconds:.3f} s with the oracle; ATE vs "
          f"golden oracle odometry {verdict['ate_odom_cm']} cm, aft-mapped "
          f"{verdict['ate_aft_cm']} cm, integrated "
          f"{verdict['ate_integrated_cm']} cm, pass {verdict['pass']}; "
          f"integrated.tum equals the in-process replay: {same} (largest "
          f"gap {np.abs(pos_cli - pos_ref).max():.6f} m); {n_map} map "
          f"points, {n_clouds} cloud files; peak device memory "
          f"{peak:.1f} MiB above the {held / 2**20:.1f} MiB held before "
          f"the run; launches {counts} [{card}]", flush=True)
    failed = [what for ok, what in (
        (verdict["pass"], f"golden verdict {verdict}"),
        (same, "integrated.tum differs from the in-process replay"))
        if not ok]
    if failed:
        raise AssertionError(f"cli bag run failed: {failed}")
    return counts, (raw, msk, cfg, streams, t_scans)


def checkpoint_phase(dev, card: str, bag_inputs) -> None:
    """checkpointed_replay of the bag's features on the card, every
    CKPT_EVERY frames: CKPT_SPLIT frames, then a new manager resumes
    from the latest checkpoint; every pose must equal an uninterrupted
    replay's bit for bit."""
    from loam_tpu_torch import checkpoint as CK, pipeline
    from loam_tpu_torch.ops.features import extract_features
    from loam_tpu_torch.types import tree_map

    raw, msk, cfg, streams, t_scans = bag_inputs
    sweeps, imu_trans, map_rpy = pipeline.ingest_frames(
        torch.as_tensor(raw, device=dev), torch.as_tensor(msk, device=dev),
        cfg, streams, t_scans)
    inputs = (extract_features(sweeps, cfg), imu_trans, map_rpy)

    def step(state, frame):
        feats, imu, rpy = frame
        return pipeline.pipeline_step(state, feats, cfg, imu=imu,
                                      map_rpy=rpy)

    def timed(fn, times):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            times.append(1e3 * (time.perf_counter() - t0))
            return result
        return call

    root = OUT_DIR / "checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    whole_state, whole = CK.checkpointed_replay(
        step, pipeline.PipelineState.create(cfg, dev), inputs,
        CK.CheckpointManager(str(root / "whole")), every=0)
    save_ms, restore_ms = [], []
    first_ck = CK.CheckpointManager(str(root / "split"))
    first_ck.save = timed(first_ck.save, save_ms)
    _, first = CK.checkpointed_replay(
        step, pipeline.PipelineState.create(cfg, dev),
        tree_map(lambda t: t[:CKPT_SPLIT], inputs), first_ck,
        every=CKPT_EVERY)
    # a new manager over the same directory, as a restarted run opens it
    ck = CK.CheckpointManager(str(root / "split"))
    ck.save = timed(ck.save, save_ms)
    ck.restore = timed(ck.restore, restore_ms)
    resumed_state, rest = CK.checkpointed_replay(
        step, pipeline.PipelineState.create(cfg, dev), inputs, ck,
        every=CKPT_EVERY)
    size = sum(p.stat().st_size
               for p in (root / "split" / str(CKPT_SPLIT)).iterdir())
    differ = [(k, name) for k, (got, want) in enumerate(zip(first + rest,
                                                             whole))
              for name in ("pose_odom", "pose_aft", "pose_integrated",
                           "mapped")
              if not torch.equal(getattr(got, name), getattr(want, name))]
    leaves_a, leaves_b = [], []
    tree_map(leaves_a.append, resumed_state)
    tree_map(leaves_b.append, whole_state)
    state_equal = all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b))
    print(f"checkpoints: {CLI_BAG_F} frames every {CKPT_EVERY}, "
          f"interrupted after {CKPT_SPLIT} and resumed at frame "
          f"{CLI_BAG_F - len(rest)}; {len(save_ms)} saves of "
          f"{size / 2**20:.1f} MiB, save ms "
          f"{[round(x, 1) for x in save_ms]}, restore ms "
          f"{[round(x, 1) for x in restore_ms]}; poses equal to the "
          f"uninterrupted replay bit for bit: {not differ}, final state "
          f"equal: {state_equal} [{card}]", flush=True)
    if len(rest) != CLI_BAG_F - CKPT_SPLIT or differ or not state_equal:
        raise AssertionError(f"resumed replay differs: frames {differ}, "
                             f"state equal {state_equal}, {len(rest)} "
                             "frames resumed")


def print_rows(rows, card: str) -> None:
    for r in rows:
        for s in r["other_shapes"] + [r]:
            lib = "none" if s["library_ms"] is None \
                else f"{s['library_ms']:.4f} ms"
            what, how, by_shape = EARLIER_MS.get(r["name"], ("", "", {}))
            was = "".join(f", {what} took {ms:.4f} ms {how}"
                          for prefix, ms in by_shape.items()
                          if s["shape"].startswith(prefix))
            print(f"kernel {r['name']}: max_abs_err {s['max_abs_err']:.3g}, "
                  f"{s['ms']:.4f} ms a call ({s['device_ms']:.4f} ms on the "
                  f"device){was}, plain {s['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {s['bound_ms']:.6f} ms by "
                  f"{s['bound_by']} ({s['shape']}) [{card}]", flush=True)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from loam_tpu_torch import configure_numerics, metrics
    from loam_tpu_torch.ops.cuda import _build

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    configure_numerics()

    secs = _build.build_all()
    print(f"built {len(_build.KERNEL_SOURCES)} kernel libraries in {secs:.1f} s from "
          f"{Path(_build.CSRC).parent}", flush=True)

    raw, msk = make_sweeps()
    imu = imu_inputs(dev)
    rows = kernel_phase(dev, raw, msk, replay_config("default"), imu)
    print_rows(rows, card)

    from golden.pipeline import run_pipeline

    oracle = run_pipeline(raw, msk)
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    launches = {}
    for name in REPLAYS:
        outs, counts, seconds = replay(name, raw_t, msk_t)
        launches[name] = counts
        poses = outs.pose_integrated.cpu().numpy()
        if not np.isfinite(poses).all():
            raise AssertionError(f"{name} replay: non-finite poses")
        ate = metrics.ate_rmse(poses[:, 3:6], oracle["integrated"][:, 3:6])
        mapped_ok = np.array_equal(outs.mapped.cpu().numpy(),
                                   oracle["mapped"])
        print(f"replay {name}: {FRAMES} frames in {seconds:.3f} s = "
              f"{FRAMES / seconds:.2f} frames/s; integrated ATE vs golden "
              f"oracle {100 * ate:.3f} cm; mapping cadence equal: "
              f"{mapped_ok}; launches {counts} [{card}]", flush=True)
        if not ate < ATE_GATE:
            raise AssertionError(
                f"{name} replay: integrated ATE {ate:.4f} m >= {ATE_GATE} m")
        if not mapped_ok:
            raise AssertionError(
                f"{name} replay: mapping cadence differs from the oracle")

    launches["imu"] = imu_phase(dev, card, imu)
    launches["batch"] = batch_phase(dev, card)
    launches["golden"], launches["golden hybrid"] = golden_phase(dev, card)
    cli_synthetic_phase(card)
    launches["cli bag"], bag_inputs = cli_bag_phase(dev, card)
    checkpoint_phase(dev, card, bag_inputs)

    # the windowed k-NN runs at k=5 in the strict replay only and at k=8
    # in the hybrid ones; every other count sums over the replays
    k8_runs = ("hybrid", "batch", "golden hybrid", "cli bag")
    for r in rows:
        if r["name"] == "knn_topk_dyn":
            r["launches"] = launches["default"]["knn_topk_dyn"]
        elif r["name"] == "knn_topk_dyn_k8":
            r["launches"] = sum(launches[n]["knn_topk_dyn"] for n in k8_runs)
        else:
            r["launches"] = sum(c[r["counter"]] for c in launches.values())
        if r["launches"] <= 0:
            raise AssertionError(f"no replay launched {r['name']}")
        if r["name"] == "select_walk":
            # the batch's frontend walks its B x F x 16 rings in one launch
            for shape in r["other_shapes"]:
                if shape["shape"].startswith(f"B={BATCH_B},"):
                    shape["launches"] = launches["batch"]["select_walk"]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "shape", "other_shapes")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
