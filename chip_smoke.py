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
  7. the long golden gates of tests/test_golden_parity.py on the card
     (their NumPy oracle runs in a process of its own beside phases 4-6):
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
     seconds, the checkpoint milliseconds and peak device memory;
  9. the online streaming engine (runtime/streaming.py) at LoamConfig(),
     its stages launching the kernels from three threads, each run's
     launches counted (knn_topk, knn_topk_dyn, odom_corr and select_walk
     must launch): (a) phase 4's 13 sweeps pushed with a drain after each,
     held to phase 4's default replay by the engine's integration rule
     (odometry and aft-mapped poses as the replay's, the integrated pose
     from the last finished mapping frame's bef/aft) within 1e-4 rad /
     1e-3 m, and to the golden oracle (integrated ATE < 5 cm); (b) phase
     8's bag sweeps with their IMU samples pushed ahead of each, paced,
     integrated ATE < 5 cm against that phase's golden IMU oracle; (c)
     40 sweeps on a 10 Hz wall clock with no drain and the live viewer,
     its page and state fetched over loopback, gated on the accounting
     (frames in = odometry frames + dropped), finite poses, a mapping
     frame and the viewer's clouds, printing the drops, the odometry
     frames/s and the device's busy share (torch.profiler); (d) 30
     sweeps with no pacing, which must drop, with the accounting held;
     (e) `python -m loam_tpu_torch --synthetic 12 --mode online` as a
     subprocess (12 poses, nothing dropped) and the HTML viewer of phase
     4's trajectories;
 10. scale-out over torch.distributed (parallel/distributed.py) and the
     one-frame entry (entry.py), at bench.py's configuration on phase 6's
     scenarios: (a) a world of one rank over NCCL, replay_distributed of
     all 8, bit-equal to phase 6's batch, with no torch.distributed call
     but the timing all_reduce; then two ranks of this script
     (`chip_smoke.py --rank R --ranks 2 --port P`, each loading its half
     from smoke_out/) that share the card over gloo: (b) dp=2 x tp=1,
     both ranks gathering identical poses within 1e-4 rad / 1e-3 m of
     phase 6's batch and agreeing on the rate; (c) dp=1 x tp=2 over 2
     scenarios, the Jacobian rows of every normal-equation sum split over
     the ranks: bit-equal across the ranks and within 5e-4 of phase 6's
     poses, printing the all_reduces a frame and the seconds beside (b)'s;
     (d) dryrun_multichip(2) at the tiny and bench configurations,
     finite; (e) scaling_efficiency at dp sizes 1 and 2, printed without
     a gate (two ranks on one card measure contention); then (f) the
     entry's forward, finite at the tiny configuration and, stepped one
     sweep at a time at LoamConfig() over phase 4's sweeps, within
     1e-4 rad / 1e-3 m of phase 4's default replay.  A rank that exits
     non-zero or outlives its timeout fails the run;
 11. loam_tpu's long-horizon gates in its corrected-semantics mode
     (odom_accumulate_rows=False, emulate_upward_scan_truncation=False)
     at tests/test_long_sequence.py's configuration (rings of 1024,
     tables of 2^15 / 2^17) on its seed-9 figure-8 of 600 azimuths: (a)
     200 frames strict, drift < 1.0 % of the distance travelled and ATE
     < 0.12 m against the ground truth; (b) the first 100 frames at
     map_exact_regather_every=5, drift < 1.5 % and ATE < 0.15 m; (c)
     (a)'s 200 frames split 120/80 around a CheckpointManager save and
     restore, the resumed integrated poses within 1e-4 of (a)'s; (a)-(c)
     must launch select_walk, knn_topk, odom_corr and knn_topk_dyn, (b)
     knn_select too; then (d) tests/test_streaming_imu.py's scenario, the
     streaming engine paced over 8 sweeps of the accelerating trajectory
     with and without its 200 Hz IMU samples: ATE < 6 cm with the IMU and
     no worse than without.  Prints frames/s, drift, ATE, the resume gap,
     the checkpoint milliseconds and the phase's seconds;
 12. the dense cell, a VLP-16 in dual-return mode at 10 Hz: 13 sweeps of
     3600 azimuths (the default cell's recipe) in rings of 3600, wider
     than 2048 and not a multiple of 32, replayed (a) strict, (b) at the
     hybrid cadence with map_exact_cache_k=16 and (c) on the cell-bucket
     map at search_bucket_cap=48 (C = 1296) and knn_candidates=40, each
     within 5 cm integrated ATE of the NumPy oracle (run in a process of
     its own beside the earlier phases) and each launching its new
     kernel instances (the walk's 4 words a lane; the k-NN's warp queue
     of W=32 at k=16; C=1296, k=40);
     then (d) `python -m loam_tpu_torch --synthetic 8 --ring-width 1800
     --golden-compare` as a subprocess, its verdict under 5 cm.  Prints
     what the feature caps cut, the local map's overflow, frames/s;
 13. the VLP-16's other rotation rates, each point's sweep time decoded
     by scan_period: (a) 300 RPM in dual-return mode, the default cell's
     recipe at scan_period 0.2 s (0.18 m and 0.02 rad a sweep), 13
     sweeps of 7200 azimuths (115,200 points) in rings of 7200, in phase
     12's three mapping modes, each within 5 cm integrated ATE of the
     NumPy oracle (its own process) and each launching the walk's 8
     words a lane; (b) 1200 RPM, the same recipe at 0.05 s, 26 sweeps of
     900 azimuths, strict, within 5 cm of its oracle; (c) the golden IMU
     scenario at 0.2 s (20 sweeps over its 4 s), held to the ground
     truth from the first sweep's end (< 0.30 m, and nearer than a no-IMU
     rerun) and moved by its IMU (> 1 mm from that rerun);
     (d) the streaming engine paced over (b)'s sweeps on its own clock
     (scan_period a sweep), equal to (b)'s replay by the engine's rule.
     Prints the feature caps' and the map's overflow, frames/s;
 14. the selection knobs and the unpruned mapping k-NN: the walk at
     suppress_neighbors 8 and 16 (reaches past 3 bits) and cut at
     corner_scan_k = flat_scan_k = 10, on phase 4's rings (B=1 x R=208,
     W=2048) and phase 13 a's (W=7200), and knn_topk_dyn K=5 at full
     windows on the mapping k-NN row's clouds, each bit for bit against
     its plain version; then phase 4's sweeps replayed strict at
     suppress_neighbors=8 and at the depth of 10, each within 5 cm
     integrated ATE of the ground truth, and at map_knn_prune=False,
     within 5 cm of the golden oracle on its cadence and within 1e-4 rad
     / 1e-3 m of phase 4's strict replay, every query block of its k-NN
     on full windows.  Prints frame 0's feature counts at each reach and
     the phase's seconds.
The kernel rows carry the batch's shapes too (B=8 scenarios), each
compared bit for bit; odom_corr_untruncated is odom_corr's walk without
the upward-scan truncation, at the corner and surf shapes, its launches
those of phase 11's figure-8 replays; knn_topk_dyn_k16, select_walk_wide
and kselect_dense are the windowed k-NN, the walk and kselect at the
shapes of phase 12 and at other k and widths, their launches phase
12's (select_walk_wide's also phase 13 a's, at its own shape, and the
5 Hz hybrid and cells replays' in knn_topk_dyn_k16 and kselect_dense);
select_walk_reach, select_walk_depth and knn_topk_dyn_full are phase
14's, their launches those of its replays at suppress_neighbors=8, at
the depth of 10 and unpruned.
The last lines are the smoke's seconds, the kernels JSON, the card's
name and power limit, and {"ok": true, "device": {...}}.
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
    "knn_topk_dyn_k16": ("the per-lane lists", "on the device",
                         {"B=1,Q=2048,M=4096,live=1153x3587,k=12,": 0.0289,
                          "B=1,Q=2048,M=4096,live=1153x3587,k=40,": 0.2869,
                          "B=1,Q=8192,M=65536,live=8192x50000,k=16,":
                          0.1927}),
    "kselect": ("the one-warp-a-query kernel", "on the device",
                {"Q=8192,C=8,k=5,": 0.0093, "Q=8192,C=24,k=5,": 0.0091,
                 "Q=2048,C=864,k=24,": 0.0276}),
    "kselect_dense": ("the kernel that staged whole rows", "on the device",
                      {"Q=1024,C=1296,k=40,": 0.0223,
                       "Q=8192,C=40,k=5,": 0.0080,
                       "Q=2048,C=1296,k=40,": 0.0410,
                       "Q=8192,C=64,k=5,": 0.0081}),
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

# the online streaming engine (phase 9), LoamConfig()
ONLINE_PATH = ("knn_topk", "knn_topk_dyn", "odom_corr", "select_walk")
ONLINE_REALTIME_F = 40      # sweeps pushed on the 10 Hz wall clock
ONLINE_FLOOD_F = 30         # sweeps pushed with no pacing after a warm one
ONLINE_CLI_F = 12

# scale-out over torch.distributed and the one-frame entry (phase 10)
SCALE_RANKS = 2             # ranks sharing the one card over gloo
SCALE_TP_B = 2              # scenarios of the row-parallel replay (c)
SCALE_TP_GATE = 5e-4        # loam_tpu's tp=2 bound (tests/test_parallel.py)
SCALE_SIZES = (1, 2)        # dp sizes of the weak-scaling harness (e)
RANK_TIMEOUT = 400          # s, the spawned ranks together
ORACLE_TIMEOUT = 600        # s, an oracle after the phases before its own

# loam_tpu's long-horizon gates (phase 11): the figure-8 of
# tests/test_long_sequence.py:29-160 and the accelerating online IMU run
# of tests/test_streaming_imu.py:22-31,69-113
LONG_F = 200
LONG_HYBRID_F = 100
LONG_AZIMUTH = 600
LONG_SEED = 9
LONG_SPLIT = 120             # frames before the checkpoint
LONG_DRIFT_GATE = 1.0        # % of the distance travelled, strict
LONG_ATE_GATE = 0.12         # m
LONG_HYBRID_DRIFT_GATE = 1.5
LONG_HYBRID_ATE_GATE = 0.15
LONG_RESUME_GATE = 1e-4      # the JAX test's atol
LONG_PATH = ("select_walk", "knn_topk", "odom_corr", "knn_topk_dyn")
# the runs in the corrected-semantics mode: odom_corr walks untruncated
UNTRUNCATED_RUNS = ("long strict", "long hybrid", "long split")
ACCEL_F = 8
ACCEL_SEED = 3
ACCEL_ATE_GATE = 0.06        # m, with the IMU
# the dense cell (phase 12): a VLP-16 in dual-return mode at 10 Hz, about
# 3,600 returns a ring a sweep: the default cell's recipe (seed 21,
# straight, 0.9 m/s, 0.1 rad/s) at twice its azimuths, in rings of 3600
# (wider than 2048 and not a multiple of 32); tables 2^17 / 2^18
DENSE_F = 13
DENSE_AZIMUTH = 3600
DENSE_WORDS = 4              # the walk's words a lane at rings of 3600
# name -> (config changes, wrappers that must launch, must not launch,
# the kernel instances that must launch: {wrapper: [tally keys]})
DENSE_MODES = {
    "dense strict": ({}, ("knn_topk", "knn_topk_dyn", "odom_corr",
                          "select_walk"), ("knn_select",),
                     {"knn_topk_dyn": [5], "select_walk": [DENSE_WORDS]}),
    "dense hybrid": (dict(map_exact_regather_every=5, map_exact_cache_k=16),
                     ("knn_topk", "knn_topk_dyn", "odom_corr", "select_walk",
                      "knn_select"), (),
                     {"knn_topk_dyn": [32], "knn_select": [(16, 5)],
                      "select_walk": [DENSE_WORDS]}),
    "dense cells": (dict(map_exact_knn=False, search_bucket_cap=48,
                         knn_candidates=40),
                    ("knn_topk", "odom_corr", "select_walk", "knn_select"),
                    ("knn_topk_dyn",),
                    {"knn_select": [(1296, 40), (40, 5)],
                     "select_walk": [DENSE_WORDS]}),
}
DENSE_CLI_F = 8
DENSE_CLI_WIDTH = 1800       # 900 azimuths in rings of 56.25 words
# the other rotation rates (phase 13): the default cell's recipe at
# 300 RPM in dual-return mode (7,200 returns a ring, the largest sweep a
# VLP-16 makes) and at 1200 RPM; tables 2^17 / 2^18
RATE5_T = 0.2                # s, scan_period at 300 RPM
RATE5_F = 13
RATE5_AZIMUTH = 7200
RATE5_WORDS = 8              # the walk's words a lane at rings of 7200
RATE5_MODES = {
    name.replace("dense", "5 Hz"):
        (over, required, forbidden, {**inst, "select_walk": [RATE5_WORDS]})
    for name, (over, required, forbidden, inst) in DENSE_MODES.items()}
RATE20_T = 0.05              # s, scan_period at 1200 RPM
RATE20_F = 26
RATE20_AZIMUTH = 900
RATE20_MODES = {"20 Hz": ({}, ("knn_topk", "knn_topk_dyn", "odom_corr",
                               "select_walk"), ("knn_select",), {})}
RATE_IMU_F = 20              # the golden IMU scenario's 4 s at 0.2 s
# the selection knobs and the unpruned mapping k-NN (phase 14) on the
# default cell: suppression reaches past the old 3-bit fields, walks cut
# under a subregion's width (2048 / 6 + 8 candidates)
REACHES = (8, 16)            # suppress_neighbors of the walk rows
SCAN_K = 10                  # corner_scan_k = flat_scan_k
KNOB_PATH = (("knn_topk", "knn_topk_dyn", "odom_corr", "select_walk"),
             ("knn_select",))
# name -> (config changes, held to: "truth" the ground truth, "oracle"
# the golden oracle and phase 4's strict replay)
KNOB_MODES = {
    "reach 8": (dict(suppress_neighbors=8), "truth"),
    "scan 10": (dict(corner_scan_k=SCAN_K, flat_scan_k=SCAN_K), "truth"),
    "unpruned": (dict(map_knn_prune=False), "oracle"),
}
POSE_NAMES = ("pose_odom", "pose_aft", "pose_integrated")
KERNELS = ("knn_topk", "knn_topk_dyn", "odom_corr", "select_walk",
           "knn_select")


def replay_config(name: str):
    from loam_tpu_torch.config import LoamConfig

    return dataclasses.replace(LoamConfig(), **REPLAYS[name][0])


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


def imu_config(scan_period: float = 0.1):
    """The golden IMU configuration: rings of 1024, the cell-bucket map."""
    from loam_tpu_torch.config import LoamConfig

    return dataclasses.replace(LoamConfig(), ring_width=1024,
                               corner_table_size=1 << 15,
                               surf_table_size=1 << 17, map_exact_knn=False,
                               scan_period=scan_period)


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


def cell_poses(frames: int = FRAMES, scan_period: float = 0.1):
    """The default cell's ground truth (frames + 1, 6): a static first
    sweep, then straight at 0.9 m/s and 0.1 rad/s; sweep k spans poses k
    to k + 1, so frame k's estimate is pose k + 1."""
    from loam_tpu_torch.io import synth

    poses = synth.straight_trajectory(frames, speed=0.9, yaw_rate=0.1,
                                      scan_period=scan_period)
    return np.vstack([poses[:1], poses])[: frames + 1]


def make_sweeps(frames: int = FRAMES, n_azimuth: int = N_AZIMUTH,
                scan_period: float = 0.1):
    """The default cell's recipe (NumPy): seed 21, cell_poses, a sweep
    every scan_period seconds."""
    from loam_tpu_torch.io import synth

    world = synth.make_world(seed=SEED)
    poses = cell_poses(frames, scan_period)
    sweeps = [synth.simulate_sweep(world, poses[k], poses[k + 1],
                                   n_azimuth=n_azimuth, seed=SEED + k)
              for k in range(frames)]
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


def sorted_cloud(rng, dev, B, Q, M, n_q, n_ref_i, margin, tq, tm):
    """B slabs of n_ref_i references (120 x 40 x 10 m) sorted on x, n_q
    queries around them (0.3 m of noise) sorted on x, and each scenario's
    tile windows at the gate `margin`: the mapping k-NN's shape.  Returns
    tensors on dev (q (B, Q, 3), ref (B, M, 3), t_lo, t_hi)."""
    from loam_tpu_torch.ops.cuda import knn_topk as KN

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
        q[..., 0], torch.full((B,), n_q, dtype=torch.int32, device=dev),
        ref[..., 0], mask.expand(B, M), tq, tm, margin + 1e-3)
    return q, ref, t_lo.contiguous(), t_hi.contiguous()


def windowed(name, k, q, ref, n_q, n_ref_i, t_lo, t_hi, tq, tm, note="",
             plain_reps=20):
    """knn_topk_dyn against its plain version on these tile windows,
    every output compared exactly; the live (n_q, n_ref_i) queries and
    references, the pairs the live query blocks scan.  Returns the
    shape's measurement dict."""
    from loam_tpu_torch.ops.cuda import knn_topk as KN

    B, Q, M = q.shape[0], q.shape[1], ref.shape[1]
    i32 = dict(dtype=torch.int32, device=q.device)
    nq_t = torch.full((B,), n_q, **i32)
    nr_t = torch.full((B,), n_ref_i, **i32)
    run_k = lambda: KN._launch(q, ref, nq_t, nr_t, k, t_lo, t_hi, tq,
                               tm)[:2]
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
        plain_ms=time_ms(run_p, reps=plain_reps),
        # materialises the live (n_q, n_ref) matrices: 1.2 GB a
        # scenario at the largest shape
        library_ms=time_ms(lambda: _library_knn(
            q[:, :n_q], ref[:, :n_ref_i], k), reps=5),
        **bound(B * (12 * (n_q + n_ref_i) + 8 * k * blocks * tq),
                PAIR_OPS * pairs))


def kernel_phase(dev, raw, msk, cfg, imu, dense, rate5):
    """Each kernel vs its plain version at the replays' shapes (dense:
    phase 12's sweeps; rate5: phase 13 a's).  Returns one row a kernel
    (its largest shape), with the other shapes' rows under
    "other_shapes"."""
    from loam_tpu_torch.ops.cuda import _build
    from loam_tpu_torch.ops.cuda import knn_topk as KN
    from loam_tpu_torch.ops.cuda import kselect as KS
    from loam_tpu_torch.ops.cuda import odom_corr as OC
    from loam_tpu_torch.ops.cuda import select_walk as SW

    # the limits the configuration check holds (it runs without the
    # libraries) are the ones the libraries report
    for lib, symbol, want in (("knn_topk", "max_k", KN.MAX_K),
                              ("kselect", "max_c", KS.MAX_C),
                              ("select_walk", "max_w", SW.MAX_W)):
        got = _build.entry(lib, (), symbol)()
        if got != want:
            raise AssertionError(f"{lib}_{symbol}() = {got}, the wrapper "
                                 f"says {want}")
        print(f"limit {lib}_{symbol}: {got}, as the wrapper says",
              flush=True)

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
            q, ref, t_lo, t_hi = sorted_cloud(rng, dev, B, Q, M, n_q,
                                              n_ref_i, margin, tq, tm)
            shapes.append(windowed(name, k, q, ref, n_q, n_ref_i, t_lo,
                                   t_hi, tq, tm))
        add(name, "knn_topk_dyn", "loam_tpu_torch/csrc/knn_topk.cu",
            "loam_tpu/ops/pallas/knn_topk.py:133", shapes)

    # ---- odom_corr: surf walks on a lattice cloud with locally unsorted
    # rings (exact ties within and across the two sides), then corner and
    # surf walks on a ring-sorted cloud, the surf walks also for the
    # batch of BATCH_B scenarios; every output compared exactly.  Then
    # the untruncated walks of the corrected-semantics mode (phase 11) at
    # the corner and surf shapes, as a row of their own
    for name, truncate, cases in (
            ("odom_corr", True, ((1, 512, 4096, True, True),
                                 (1, 256, 2048, False, False),
                                 (BATCH_B, 512, 16384, True, False),
                                 (1, 512, 16384, True, False))),
            ("odom_corr_untruncated", False,
             ((1, 256, 2048, False, False), (1, 512, 16384, True, False)))):
        shapes = []
        for B, Q, M, surf, ties in cases:
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
            kw = dict(surf=surf, window=cfg.ring_window, truncate=truncate)
            run_k = lambda: OC._launch(*args, **kw)
            run_p = lambda: OC.odom_corr_plain(*args, **kw)
            up, dn, _, _ = OC.walk_masks(ring_t, j1, n_q, n_ref,
                                         window=cfg.ring_window,
                                         truncate=truncate)
            visited = int(up.sum()) + int(dn.sum())
            shapes.append(dict(
                shape=f"B={B},Q={Q},M={M},live={live},"
                      f"{'surf' if surf else 'corner'},visited={visited}"
                      + (",lattice" * ties) + f",truncate={truncate}",
                max_abs_err=_compare("odom_corr", run_k(), run_p()),
                ms=time_ms(run_k), device_ms=device_ms(run_k),
                plain_ms=time_ms(run_p), library_ms=None,
                # + a ring compare per visited point
                **bound(B * (12 * Q + 16 * live + 4 * Q + 16 * Q),
                        (PAIR_OPS + 1) * visited)))
        add(name, "odom_corr", "loam_tpu_torch/csrc/odom_corr.cu",
            "loam_tpu/ops/pallas/odom_corr.py:65", shapes)

    # ---- knn_topk_dyn at k other than 1, 5 and 8: the register lists
    # at K = 3 and the warp queue at k = 12, 24, 32, 40, 100 and MAX_K
    # on the lattice shape, then the dense cell's hybrid gather (phase
    # 12 b: map_exact_cache_k = 16, margin 2 m) at the caps its sweeps
    # fill, the whole surf stack against 50000 map points, at k = 24, 32
    # and 40 and last at its own k = 16
    Q, M = 8 * tq, 8 * tm
    t_lo = torch.tensor([[0, 7, 3, 2, -1, 0, 0, 0]], **i32)
    t_hi = torch.tensor([[8, 8, 3, 5, 99, 8, 8, 8]], **i32)
    q_l = torch.tensor(lattice(rng, (1, Q, 3)), device=dev)
    r_l = torch.tensor(lattice(rng, (1, M, 3)), device=dev)
    shapes = [windowed("knn_topk_dyn_k16", k, q_l, r_l, 4 * tq + tq // 2 + 1,
                       7 * tm + 3, t_lo, t_hi, tq, tm, ",lattice")
              for k in (3, 12, 24, 32, 40, 100, KN.MAX_K)]
    q, ref, t_lo, t_hi = sorted_cloud(rng, dev, 1, 8192, 65536, 8192, 50000,
                                      2.0, tq, tm)
    shapes += [windowed("knn_topk_dyn_k16", k, q, ref, 8192, 50000, t_lo,
                        t_hi, tq, tm) for k in (24, 32, 40, 16)]
    add("knn_topk_dyn_k16", "knn_topk_dyn", "loam_tpu_torch/csrc/knn_topk.cu",
        "loam_tpu/ops/pallas/knn_topk.py:133", shapes)

    rows.append(select_walk_row(dev, raw, msk, cfg, imu))
    rows.append(wide_walk_row(dev, raw, msk, dense, rate5))

    # ---- kselect, every output compared exactly: lattice candidates
    # (exact ties in every row), the hybrid re-rank (C=8), the cell
    # re-rank (C=24), the 27-cell gather chunk at k=1 (distances and one
    # round: what the other 23 rounds of the next shape cost) and at k=24
    # (C=864: ~60% valid, the second half of every row's cells
    # duplicated, some rows with fewer than k valid); the hybrid re-rank
    # also at the batch's BATCH_B x 8192 rows.  Then the dense cell's
    # (phase 12 c): lattice candidates at its gather shape, its re-rank
    # (C=40, k=5), its gather chunk (search_bucket_cap 48: C=1296,
    # k=40) and the widest re-rank of the group kernel (C=64)
    def selection(Q, C, k, ties):
        if ties:
            q_np = lattice(rng, (Q, 3))
            cand_np = lattice(rng, (Q, C, 3), half=3)
        else:
            q_np = rng.uniform(-30, 30, (Q, 3)).astype(np.float32)
            cand_np = (q_np[:, None, :]
                       + rng.normal(0, 0.8, (Q, C, 3))).astype(np.float32)
        valid_np = rng.uniform(size=(Q, C)) < 0.6
        if C >= 864:
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
        return dict(
            shape=f"Q={Q},C={C},k={k},valid={n_valid}" + (",lattice" * ties),
            max_abs_err=_compare("kselect", run_k(), run_p()),
            ms=time_ms(run_k), device_ms=device_ms(run_k),
            plain_ms=time_ms(run_p), library_ms=time_ms(run_lib),
            # 8 flops a valid candidate, then k scans of C compares
            **bound(Q * C * 13 + Q * 12 + Q * k * 16,
                    8 * n_valid + Q * C * k))

    for name, cases in (
            ("kselect", ((8200, 24, 5, True), (1024, 864, 24, True),
                         (8192, 8, 5, False), (BATCH_B * 8192, 8, 5, False),
                         (8192, 24, 5, False), (2048, 864, 1, False),
                         (2048, 864, 24, False))),
            ("kselect_dense", ((1024, 1296, 40, True), (8192, 40, 5, False),
                               (8192, 64, 5, False),
                               (2048, 1296, 40, False)))):
        add(name, "knn_select", "loam_tpu_torch/csrc/kselect.cu",
            "loam_tpu/ops/pallas/kselect.py:33",
            [selection(*case) for case in cases])
    torch.cuda.synchronize()
    return rows


def walk_inputs(sweep, cfg):
    """The walk's inputs for every ring of `sweep` at cfg (its reach and
    depths): corner and flat meta, the pre-picked masks, the wrapper's
    keywords, and what the serial NumPy walk of tests/torch_parity counts
    for them: candidates walked (meta words read), picks, and the
    kernel's rounds (32-candidate chunks plus picks)."""
    from loam_tpu_torch.ops import features as FT
    from torch_parity import serial_walk, walk_kwargs

    curv, gap, pre, counts = FT.selection_inputs(sweep, cfg)
    W = cfg.ring_width
    cm, fm = FT.walk_meta(curv.reshape(-1, W), gap.reshape(-1, W),
                          counts.reshape(-1), cfg)
    pre = pre.reshape(-1, W)
    kw = walk_kwargs(cfg, W, cfg.corner_scan_k, cfg.flat_scan_k)
    _, need = serial_walk(cm.cpu().numpy(), fm.cpu().numpy(),
                          pre.cpu().numpy(), **kw)
    return cm, fm, pre, kw, need


def walk_shape(rings, B, R, note=""):
    """select_walk against its plain version on B x R of `rings`
    (walk_inputs; tiled when B x R is more), every output compared
    exactly.  Returns the shape's measurement dict."""
    from loam_tpu_torch.ops.cuda import select_walk as SW

    cm_all, fm_all, pre, kw, need = rings
    W = kw["W"]
    dev = cm_all.device
    idx = torch.arange(B * R, device=dev) % cm_all.shape[0]
    cm = cm_all[idx].reshape(B, R, -1).contiguous()
    fm = fm_all[idx].reshape(B, R, -1).contiguous()
    p0 = SW.pack_bits(pre[idx]).reshape(B, R, -1)
    n = {k: int(v[idx.cpu().numpy()].sum()) for k, v in need.items()}
    max_rounds = int(need["rounds"][idx.cpu().numpy()].max())
    run_k = lambda: SW._launch(cm, fm, p0, **kw)[0]
    run_p = lambda: SW.select_walk_plain(cm, fm, p0, **kw)
    return dict(
        shape=f"B={B},R={R},W={W},walked={n['walked']},"
              f"picks={n['picks']},rounds={n['rounds']},"
              f"max_rounds={max_rounds}" + note,
        max_abs_err=_compare("select_walk", run_k(), run_p()),
        ms=time_ms(run_k), device_ms=device_ms(run_k),
        plain_ms=time_ms(run_p, reps=5), library_ms=None,
        # 4 bytes a walked meta word and a uint32 word of each bit-field
        # (pre-picked in, four out: the walk needs no more, whatever the
        # wrapper's int64 holds); about 20 integer operations a walked
        # candidate
        **bound(4 * n["walked"] + 5 * 4 * B * R * SW.words_for(W),
                20 * n["walked"]))


def walk_row(name, shapes):
    """A kernels JSON row of select_walk, its own shape the last."""
    torch.cuda.synchronize()
    return dict(name=name, counter="select_walk", route="cuda",
                source="loam_tpu_torch/csrc/select_walk.cu",
                replaces="loam_tpu/ops/pallas/select_walk.py:81",
                **{**shapes[-1], "max_abs_err": max(
                    s["max_abs_err"] for s in shapes)},
                other_shapes=shapes[:-1])


def select_walk_row(dev, raw, msk, cfg, imu):
    """select_walk at one frame's rings (online use at 10 Hz), bench.py's
    batch (B=8 scenarios x 17 frames, filled by tiling the replay's rings),
    every ring of the IMU replay (imu_inputs: deskewed, rings of 1024) and
    every ring of the replay (the row's own shape); every output compared
    exactly (walk_shape)."""
    from loam_tpu_torch import frontend, pipeline

    replay_rings = walk_inputs(frontend.ingest_sweep(
        torch.tensor(raw, device=dev), torch.tensor(msk, device=dev), cfg),
        cfg)
    (iraw, imsk, stream, t_scans), _ = imu
    imu_rings = walk_inputs(pipeline.ingest_frames(
        iraw, imsk, imu_config(), stream, t_scans)[0], imu_config())
    n_rings, n_imu = replay_rings[0].shape[0], imu_rings[0].shape[0]
    return walk_row("select_walk", [
        walk_shape(replay_rings, 1, cfg.n_scans),
        walk_shape(replay_rings, 8, 17 * cfg.n_scans),
        walk_shape(imu_rings, 1, n_imu, ",imu"),
        walk_shape(replay_rings, 1, n_rings)])


def wide_walk_row(dev, raw, msk, dense, rate5):
    """select_walk at widths past 2048 or not a multiple of 32: every
    ring of phase 4's sweeps in rings of 1800 (phase 12 d's width; 57
    words, 2 a lane), of 4 sweeps of 7200 azimuths (a
    VLP-16 at 300 RPM in dual-return mode) in rings of 8192 (8 words a
    lane), of the dense cell's sweeps in rings of 3600 (113 words, 4 a
    lane) and of phase 13 a's sweeps in rings of 7200 (225 words, 8 a
    lane: the row's own shape)."""
    from loam_tpu_torch import frontend
    from loam_tpu_torch.io import synth

    def rings(raw, msk, cfg):
        return walk_inputs(frontend.ingest_sweep(
            torch.tensor(raw, device=dev), torch.tensor(msk, device=dev),
            cfg), cfg)

    world = synth.make_world(seed=SEED)
    poses = synth.straight_trajectory(4, speed=0.9, yaw_rate=0.1)
    poses = np.vstack([poses[:1], poses])[:5]
    sweeps = [synth.simulate_sweep(world, poses[k], poses[k + 1],
                                   n_azimuth=2 * DENSE_AZIMUTH, seed=SEED + k)
              for k in range(4)]
    fast = (np.stack([x for x, _ in sweeps]).astype(np.float32),
            np.stack([m for _, m in sweeps]))
    shapes = []
    for (r, m), W in (((raw, msk), 1800), (fast, 8192), (dense, 3600),
                      (rate5, RATE5_AZIMUTH)):
        cfg = dataclasses.replace(dense_config(), ring_width=W)
        ring_set = rings(r, m, cfg)
        shapes.append(walk_shape(ring_set, 1, ring_set[0].shape[0]))
    return walk_row("select_walk_wide", shapes)


def counted_replay(name, required, forbidden, warm_up, run):
    """warm_up() (library handles, allocator; uncounted), then run() with
    every launch count zeroed just before it and read just after it.
    Returns (outputs, launch counts, seconds); counts["instances"] holds
    the launches by kernel instance.  Raises when a kernel of
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
    # launches by kernel instance: k of the windowed k-NN, (C, k) of
    # kselect, the walk's words a lane
    tallies = {"knn_topk_dyn": KN.knn_topk_dyn.by_k,
               "knn_select": KS.knn_select.by_shape,
               "select_walk": SW.select_walk.by_words}
    for fn in wrappers.values():
        fn.launches = 0
    for tally in tallies.values():
        tally.clear()
    t0 = time.perf_counter()
    outs = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in wrappers.items()}
    counts["instances"] = {n: dict(t) for n, t in tallies.items()}
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


def imu_sequence(frames: int = IMU_FRAMES, scan_period: float = 0.1):
    """The raw sweeps of the golden IMU scenario and the noise-free IMU
    stream of its trajectory (imu_samples), a sweep every scan_period
    seconds.  A NumPy copy of
    tests/test_golden_parity_imu._make_imu_sequence."""
    from loam_tpu_torch.io import synth
    from torch_parity import imu_samples

    world = synth.make_world(seed=IMU_SEED)
    pose_fn = synth.oscillating_trajectory()
    t_scans = IMU_T0 + scan_period * np.arange(frames)
    sweeps = [synth.simulate_sweep_traj(world, pose_fn, t0=float(t),
                                        scan_period=scan_period,
                                        n_azimuth=IMU_AZIMUTH,
                                        seed=IMU_SEED + k)
              for k, t in enumerate(t_scans)]
    raw = np.stack([s[0] for s in sweeps])
    msk = np.stack([s[1] for s in sweeps])
    imu_t, rpy, acc = imu_samples(pose_fn, float(t_scans[-1]) + 0.25,
                                  IMU_RATE)
    return (raw, msk, imu_t, rpy.astype(np.float32), acc.astype(np.float32),
            t_scans, pose_fn)


def frame_windows(imu_t, rpy, acc, t_scans, horizon: float = IMU_HORIZON):
    """Per-frame windows (t, rpy, acc, mask; leading frame axis) over the
    samples the oracle is fed, from t_scan - IMU_LEAD to t_scan +
    horizon, valid samples first.  A NumPy copy of
    tests/test_golden_parity_imu._frame_windows."""
    F = t_scans.shape[0]
    t_w = np.zeros((F, IMU_CAP), np.float32)
    r_w = np.zeros((F, IMU_CAP, 3), np.float32)
    a_w = np.zeros((F, IMU_CAP, 3), np.float32)
    m_w = np.zeros((F, IMU_CAP), bool)
    for f, t0 in enumerate(t_scans):
        sel = np.nonzero((imu_t >= t0 - IMU_LEAD)
                         & (imu_t <= t0 + horizon))[0]
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
    launch counts and (raw, mask, the batch's FrameOutput)."""
    from loam_tpu_torch import pipeline
    from loam_tpu_torch.entry import bench_cfg
    from loam_tpu_torch.parallel import replay as PR

    cfg = bench_cfg()
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
        for n in KERNELS:
            single_counts[n] = single_counts.get(n, 0) + c[n]
    # host reads of each mapping frame: the batch's, and the most any
    # single replay makes at that frame
    _, batch_reads = mapping_host_reads(
        lambda: PR.batched_replay(raw_t, msk_t, cfg))
    single_reads = np.max([mapping_host_reads(
        lambda: pipeline.replay_sweeps(raw_t[b], msk_t[b], cfg))[1]
        for b in range(BATCH_B)], 0).tolist()
    failed, gap, per = [], [0.0, 0.0], []
    for b, one in enumerate(singles):
        got = {n: getattr(outs, n)[b].cpu().numpy() for n in
               ("pose_odom", "pose_aft", "pose_integrated", "mapped")}
        if not np.isfinite(got["pose_integrated"]).all():
            failed.append(f"scenario {b}: non-finite poses")
        if not np.array_equal(got["mapped"], one.mapped.cpu().numpy()):
            failed.append(f"scenario {b}: cadence differs from its single "
                          "replay")
        mine = [0.0, 0.0]
        for n in ("pose_odom", "pose_aft", "pose_integrated"):
            d = np.abs(got[n].astype(np.float64)
                       - getattr(one, n).cpu().numpy())
            rot, trans = float(d[:, :3].max()), float(d[:, 3:].max())
            mine = [max(mine[0], rot), max(mine[1], trans)]
            if not (rot < BATCH_ROT and trans < BATCH_TRANS):
                failed.append(f"scenario {b} {n}: {rot} rad, {trans} m "
                              "from its single replay")
        per.append(f"{mine[0]:.3g} rad / {mine[1]:.3g} m")
        gap = [max(gap[0], mine[0]), max(gap[1], mine[1])]
    frames = BATCH_B * BATCH_F
    print(f"replay batch: {BATCH_B} x {BATCH_F} frames in {seconds:.3f} s "
          f"= {frames / seconds:.2f} frames/s batched; the {BATCH_B} "
          f"single replays {frames / single_s:.2f} frames/s "
          f"({single_s:.3f} s); largest pose gap to them {gap[0]:.3g} rad, "
          f"{gap[1]:.3g} m (by scenario: {'; '.join(per)}); peak device "
          f"memory {peak:.1f} MiB; host "
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
    return counts, (raw, msk, outs)


def oracle_process(name: str, out: str) -> int:
    """A NumPy oracle in a process of its own, started by start_oracle as
    `chip_smoke.py --oracle NAME OUT`: phase 7's golden sequence, phase
    12's dense sweeps or phase 13's sweeps at 5 Hz or 20 Hz through
    tests/golden/pipeline.run_pipeline, its trajectories and seconds
    saved to OUT (.npz).  The oracle encodes and decodes each point's
    sweep time with a fixed 0.1 s, which without an IMU gives every
    point its own sweep fraction at any rate."""
    sys.path.insert(0, str(ROOT / "tests"))
    from golden.pipeline import run_pipeline

    sweeps = {"golden": golden_sequence, "dense": dense_sweeps,
              "rate5": rate5_sweeps, "rate20": rate20_sweeps}[name]()
    t0 = time.perf_counter()
    oracle = run_pipeline(*sweeps)
    np.savez(out, seconds=time.perf_counter() - t0, **oracle)
    return 0


def start_oracle(name: str):
    """Start oracle_process beside the card's phases, on one BLAS thread
    (its trajectories are those of any thread count, bit for bit; one
    thread leaves the host's other cores to the replays).  Returns
    (name, process, output path, log path)."""
    import atexit
    import os

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / f"{name}_oracle.npz"
    out.unlink(missing_ok=True)
    log = OUT_DIR / f"{name}_oracle.log"
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--oracle", name,
             str(out)], stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
            env=env)
    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    # a phase that fails first leaves no oracle running
    atexit.register(stop)
    return name, proc, out, log


def wait_oracle(started) -> dict:
    """The oracle's trajectories, once its process has ended; raises with
    the end of its log when it fails or outlives ORACLE_TIMEOUT."""
    name, proc, out, log = started
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=ORACLE_TIMEOUT)
    except subprocess.TimeoutExpired as exc:
        raise AssertionError(f"the {name} oracle did not finish in "
                             f"{ORACLE_TIMEOUT} s") from exc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        raise AssertionError(f"the {name} oracle exited {proc.returncode}:"
                             f"\n{log.read_text()[-3000:]}")
    oracle = dict(np.load(out))
    print(f"{name}: the oracle in {float(oracle.pop('seconds')):.1f} s on "
          f"the host beside the card's phases, waited for "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return oracle


def golden_phase(dev, card: str, oracle: dict):
    """The long golden gates of tests/test_golden_parity.py on the card,
    against the oracle's trajectories (wait_golden_oracle).  Returns the
    launch counts of its two replays."""
    from loam_tpu_torch import metrics, pipeline

    raw, msk = golden_sequence()
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
    from torch_parity import (imu_samples, raw_imu, rpy_to_quat,
                              write_sweep_bag)

    t0 = time.perf_counter()
    world = synth.make_world(seed=CLI_BAG_SEED)
    pose_fn = synth.oscillating_trajectory()
    t_scans = IMU_T0 + 0.1 * np.arange(CLI_BAG_F)
    sweeps = [synth.simulate_sweep_traj(world, pose_fn, t0=float(t),
                                        n_azimuth=CLI_BAG_AZIMUTH,
                                        seed=CLI_BAG_SEED + k)
              for k, t in enumerate(t_scans)]
    imu_t, pyr, acc = imu_samples(pose_fn, float(t_scans[-1]) + 0.25,
                                  IMU_RATE)
    rpy, acc_velodyne = raw_imu(pyr, acc)
    write_sweep_bag(path, sweeps, CLI_BAG_T0 + t_scans,
                    (CLI_BAG_T0 + imu_t, rpy_to_quat(rpy), acc_velodyne))
    return time.perf_counter() - t0


def cli_bag_phase(dev, card: str):
    """cli.main over the IMU bag in this process, its launches counted,
    held to a replay_sweeps of the same loaded arrays and windows.
    Returns (launch counts, the loaded bag: the replay's inputs on the
    card, the stamps, the raw IMU samples and the oracle's result)."""
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

    # keep the oracle run that --golden-compare makes, for phase 9
    import golden.pipeline as golden_pipeline

    oracle_imu = golden_pipeline.run_pipeline_imu
    captured = {}

    def capture(*args, **kw):
        captured["oracle"] = oracle_imu(*args, **kw)
        return captured["oracle"]

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # by the earlier phases
    golden_pipeline.run_pipeline_imu = capture
    try:
        rc, counts, seconds = counted_replay("cli bag", CLI_BAG_PATH, (),
                                             lambda: None, run)
    finally:
        golden_pipeline.run_pipeline_imu = oracle_imu
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
    return counts, dict(raw=raw, msk=msk, cfg=cfg, streams=streams,
                        t_scans=t_scans, stamps=stamps, imu=imu,
                        oracle=captured["oracle"])


def checkpoint_phase(dev, card: str, bag_inputs) -> None:
    """checkpointed_replay of the bag's features on the card, every
    CKPT_EVERY frames: CKPT_SPLIT frames, then a new manager resumes
    from the latest checkpoint; every pose must equal an uninterrupted
    replay's bit for bit."""
    from loam_tpu_torch import checkpoint as CK, pipeline
    from loam_tpu_torch.ops.features import extract_features
    from loam_tpu_torch.types import tree_map

    raw, msk, cfg, streams, t_scans = (bag_inputs[k] for k in (
        "raw", "msk", "cfg", "streams", "t_scans"))
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


def oracle_online_rule(oracle):
    """The oracle's trajectory integrated as the streaming engine
    integrates: frame k's odometry pose composed with the bef/aft pair
    that held before frame k.  A mapping frame that solved set bef to
    its odometry pose and aft to its refined pose (tests/golden/
    mapping.py); one that did not changed neither, so its aft-mapped
    pose is the one before."""
    from golden.mapping import transform_associate_to_map

    bef, aft = np.zeros(6), np.zeros(6)
    out = []
    for k in range(oracle["odom"].shape[0]):
        out.append(transform_associate_to_map(oracle["odom"][k], bef, aft))
        if oracle["mapped"][k] and not np.array_equal(oracle["aft"][k], aft):
            bef, aft = oracle["odom"][k], oracle["aft"][k]
    return np.stack(out)


def online_phase(dev, card: str, raw, msk, default_outs, oracle, bag):
    """The streaming engine at LoamConfig() on the card: (a) paced over
    make_sweeps(), held to the default replay by the integration rule;
    (b) paced over the bag's sweeps with its IMU samples pushed ahead of
    each, held to the bag's golden IMU oracle; (c) real time with the
    live viewer; (d) a flood; (e) the command line's online mode and the
    HTML viewer.  The integrated trajectories are held to the oracle's
    integrated by the same rule (oracle_online_rule); against the
    oracle's own integration, which waits for the frame's mapping, (a)
    is held too and (b) printed.  Returns the launch counts of (a)-(d)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu_torch import imu as imu_mod, metrics, viz
    from loam_tpu_torch.config import LoamConfig
    from loam_tpu_torch.io import export
    from loam_tpu_torch.runtime.streaming import StreamingEngine
    from loam_tpu_torch.viz_live import LiveServer
    from torch_parity import online_rule_replay, paced_engine_run

    t_phase = time.perf_counter()
    cfg = LoamConfig()
    launches = {}
    failed = []

    def engine(config=cfg):
        eng = StreamingEngine(config, device=dev)
        eng.start()
        return eng

    # (a) paced, against phase 4's default replay
    t_scans = 0.1 * np.arange(raw.shape[0])

    def run_a():
        eng = engine()
        try:
            return paced_engine_run(eng, raw, msk, t_scans), eng.stats()
        finally:
            eng.stop()

    ((odom, aft, integrated), st), launches["online paced"], secs = \
        counted_replay("online paced", ONLINE_PATH, ("knn_select",),
                       lambda: None, run_a)
    ref, online = online_rule_replay(raw, msk, cfg, dev)
    same = all(torch.equal(getattr(ref, n), getattr(default_outs, n))
               for n in ("pose_odom", "pose_aft", "pose_integrated", "mapped"))
    gaps = [np.abs(a.astype(np.float64) - b.cpu().numpy())
            for a, b in ((odom, ref.pose_odom), (aft, ref.pose_aft),
                         (integrated, online))]
    rot = max(float(g[:, :3].max()) for g in gaps)
    trans = max(float(g[:, 3:].max()) for g in gaps)
    ate = metrics.ate_rmse(integrated[:, 3:6], oracle["integrated"][:, 3:6])
    ate_rule = metrics.ate_rmse(integrated[:, 3:6],
                                oracle_online_rule(oracle)[:, 3:6])
    print(f"online (a) paced: {raw.shape[0]} sweeps in {secs:.3f} s = "
          f"{raw.shape[0] / secs:.2f} frames/s with a drain after each; "
          f"{st.odom_frames} odometry, {st.map_frames} mapping frames; "
          f"largest gap to the default replay by the integration rule "
          f"{rot:.3g} rad, {trans:.3g} m (the stepwise replay equals phase "
          f"4's: {same}); integrated ATE vs golden oracle by the same rule "
          f"{100 * ate_rule:.3f} cm, vs the oracle's own integration "
          f"{100 * ate:.3f} cm; launches {launches['online paced']} "
          f"[{card}]", flush=True)
    if not (rot < BATCH_ROT and trans < BATCH_TRANS):
        failed.append(f"(a) {rot} rad, {trans} m from the replay")
    if not (same and ate < ATE_GATE and ate_rule < ATE_GATE
            and np.isfinite(integrated).all()):
        failed.append(f"(a) stepwise replay equal {same}, ATE {ate_rule} m "
                      f"by the rule, {ate} m")

    # (b) the bag's oscillating sweeps with their IMU, paced
    base = bag["stamps"][0]
    imu_t, imu_rpy, imu_acc = bag["imu"]
    imu = (imu_t - base, imu_rpy, imu_acc)
    b_scans = bag["stamps"] - base

    def run_b():
        eng = engine()
        try:
            return (paced_engine_run(eng, bag["raw"], bag["msk"], b_scans,
                                     imu),
                    [eng._imu_window(float(t)) for t in b_scans])
        finally:
            eng.stop()

    ((odom_b, _, integ_b), windows), launches["online imu"], secs = \
        counted_replay("online imu", ONLINE_PATH, ("knn_select",),
                       lambda: None, run_b)
    golden = bag["oracle"]
    ate_b = metrics.ate_rmse(integ_b[:, 3:6],
                             oracle_online_rule(golden)[:, 3:6])
    streams = imu_mod.imu_from_raw(*(
        torch.tensor(np.stack([w[i] for w in windows]), device=dev)
        for i in range(4)))
    ref_b, online_b = online_rule_replay(
        bag["raw"], bag["msk"], cfg, dev, streams,
        torch.tensor(b_scans.astype(np.float32), device=dev))
    gap_b = max(float(np.abs(odom_b - ref_b.pose_odom.cpu().numpy()).max()),
                float(np.abs(integ_b - online_b.cpu().numpy()).max()))
    own = golden["integrated"][:, 3:6]
    ate_own = metrics.ate_rmse(integ_b[:, 3:6], own)
    ate_replay = metrics.ate_rmse(ref_b.pose_integrated[:, 3:6], own)
    print(f"online (b) imu: {len(b_scans)} sweeps of {CLI_BAG_AZIMUTH} "
          f"azimuths and {imu_t.shape[0]} IMU samples pushed ahead of "
          f"them, {secs:.3f} s = {len(b_scans) / secs:.2f} frames/s paced; "
          f"integrated ATE vs the bag's golden IMU oracle (phase 8) by the "
          f"same rule {100 * ate_b:.3f} cm, vs the oracle's own "
          f"integration {100 * ate_own:.3f} cm (the replay of the same "
          f"windows, integrated after each mapping frame: "
          f"{100 * ate_replay:.3f} cm); largest gap to that replay by the "
          f"rule {gap_b:.3g}; launches {launches['online imu']} "
          f"[{card}]", flush=True)
    if not (ate_b < ATE_GATE and np.isfinite(integ_b).all()):
        failed.append(f"(b) integrated ATE {ate_b} m by the rule")

    # (c) real time: 10 Hz wall clock, no drain, the live viewer
    rt_raw, rt_msk = make_sweeps(ONLINE_REALTIME_F)
    live_cfg = dataclasses.replace(cfg, emit_registered=True)
    fetched = {}

    def run_c():
        eng = engine(live_cfg)
        live = LiveServer(eng, port=0).start()
        try:
            t0 = time.perf_counter()
            for k in range(ONLINE_REALTIME_F):
                delay = t0 + 0.1 * k - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                eng.push_sweep(rt_raw[k], rt_msk[k])
                if k == ONLINE_REALTIME_F // 2:
                    fetched["page"] = fetch(live.url)
                    fetched["mid"] = json.loads(fetch(live.url + "state.json"))
            pushed_s = time.perf_counter() - t0
            if not eng.drain(timeout_s=300):
                raise AssertionError("(c) the engine did not drain")
            run_s = time.perf_counter() - t0
            fetched["end"] = json.loads(fetch(live.url + "state.json"))
            return eng.stats(), eng.trajectory(), pushed_s, run_s
        finally:
            live.stop()
            eng.stop()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (st, traj, pushed_s, run_s), launches["online realtime"], _ = \
            counted_replay("online realtime", ONLINE_PATH, ("knn_select",),
                           lambda: None, run_c)
    device_s = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e6
    q = st.queue_stats
    drops = {n: q[n]["dropped"] for n in ("raw", "feats", "map")}
    end = fetched["end"]
    print(f"online (c) real time: {st.frames_in} sweeps in at 10 Hz "
          f"({pushed_s:.3f} s), {st.odom_frames} odometry frames, "
          f"{st.map_frames} mapping frames, dropped {drops}; odometry "
          f"{st.odom_frames / run_s:.2f} frames/s over the {run_s:.3f} s "
          f"run; device busy {device_s:.4f} s = {device_s / run_s:.4f} of "
          f"the run (torch.profiler); live viewer: page "
          f"{len(fetched['page'])} bytes, mid-run state at odometry frame "
          f"{fetched['mid']['stats']['odom_frames']}, final state "
          f"{len(end['surround'])} surround and {len(end['registered'])} "
          f"registered points; launches {launches['online realtime']} "
          f"[{card}]", flush=True)
    if st.frames_in != st.odom_frames + drops["raw"] + drops["feats"]:
        failed.append(f"(c) accounting: {st}")
    if not (np.isfinite(traj).all() and st.map_frames >= 1):
        failed.append(f"(c) {st.map_frames} mapping frames, finite "
                      f"{np.isfinite(traj).all()}")
    if not (b"state.json" in fetched["page"] and len(end["surround"]) > 100
            and len(end["registered"]) > 0):
        failed.append(f"(c) live viewer: {len(end['surround'])} surround, "
                      f"{len(end['registered'])} registered points")

    # (d) a flood after one warm sweep
    def run_d():
        eng = engine()
        try:
            eng.push_sweep(raw[0], msk[0])
            eng.drain(timeout_s=300)
            for k in range(ONLINE_FLOOD_F):
                eng.push_sweep(raw[k % raw.shape[0]], msk[k % raw.shape[0]])
            if not eng.drain(timeout_s=300):
                raise AssertionError("(d) the engine did not drain")
            return eng.stats()
        finally:
            eng.stop()

    st, launches["online flood"], secs = counted_replay(
        "online flood", ONLINE_PATH, ("knn_select",), lambda: None, run_d)
    q = st.queue_stats
    drops = {n: q[n]["dropped"] for n in ("raw", "feats", "map")}
    print(f"online (d) flood: {st.frames_in} sweeps in, {st.odom_frames} "
          f"odometry frames, {st.map_frames} mapping frames, dropped "
          f"{drops}, {secs:.3f} s; launches {launches['online flood']} "
          f"[{card}]", flush=True)
    if not (st.frames_in == ONLINE_FLOOD_F + 1 and drops["raw"] > 0
            and st.odom_frames + drops["raw"] + drops["feats"]
            == st.frames_in):
        failed.append(f"(d) {st}")

    # (e) the command line's online mode, and the HTML viewer
    out = OUT_DIR / "cli_online"
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "loam_tpu_torch", "--synthetic",
           str(ONLINE_CLI_F), "--mode", "online", "--out-dir", str(out)]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    cli_s = time.perf_counter() - t0
    line = [ln for ln in done.stdout.splitlines() if "] online: " in ln]
    n_poses = 0
    if done.returncode == 0:
        t_cli, pos, _ = export.load_trajectory_tum(str(out /
                                                       "integrated.tum"))
        n_poses = int(np.isfinite(pos).all(1).sum())
    html = OUT_DIR / "viewer.html"
    viz.export_html_viewer(
        str(html), {"integrated": default_outs.pose_integrated,
                    "aft_mapped": default_outs.pose_aft,
                    "odom": default_outs.pose_odom})
    print(f"online (e) command line: exit {done.returncode} in {cli_s:.1f} "
          f"s, {n_poses} finite poses in integrated.tum, "
          f"{line[0] if line else 'no online line'}; viewer.html "
          f"{html.stat().st_size} bytes [{card}]", flush=True)
    want = f"{ONLINE_CLI_F} odometry frames"
    if not (done.returncode == 0 and n_poses == ONLINE_CLI_F and line
            and want in line[0] and ", 0 dropped," in line[0]):
        failed.append(f"(e) {' '.join(cmd[1:])}: exit {done.returncode}, "
                      f"{n_poses} poses:\n{done.stdout[-2000:]}\n"
                      f"{done.stderr[-3000:]}")
    if b'"name":"integrated"' not in html.read_bytes():
        failed.append("(e) viewer.html holds no integrated trajectory")
    print(f"online phase: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    if failed:
        raise AssertionError(f"online engine failed its gates: {failed}")
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pose_gap(got: dict, want: dict) -> tuple[float, float]:
    """Largest rotation (rad) and translation (m) gaps of the poses in
    got to those in want (name -> NumPy (B, F, 6) each)."""
    rot = trans = 0.0
    for n in POSE_NAMES:
        d = np.abs(np.asarray(got[n], np.float64) - want[n])
        rot, trans = max(rot, float(d[..., :3].max())), \
            max(trans, float(d[..., 3:].max()))
    return rot, trans


def scale_rank(rank: int, ranks: int, port: int) -> int:
    """One rank of phase 10, started by scale_out_phase as
    `chip_smoke.py --rank R --ranks N --port P`: over gloo with the other
    ranks on the one card, (b) replay_distributed of this rank's
    scenarios (smoke_out/scale_rank<R>.npz) on a dp mesh, the poses
    gathered; (e) scaling_efficiency at dp sizes SCALE_SIZES; (c) the
    row-parallel replay of smoke_out/scale_tp.npz on a tp mesh; (d)
    dryrun_multichip over every rank.  Launches and torch.distributed
    calls are counted around each.  Writes smoke_out/scale_out<R>.npz."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from loam_tpu_torch import configure_numerics
    from loam_tpu_torch.entry import bench_cfg, dryrun_multichip
    from loam_tpu_torch.parallel import distributed as D
    from loam_tpu_torch.parallel import replay as PR
    from torch_dcn_worker import count_collectives

    dev = torch.device("cuda", 0)
    D.initialize(f"127.0.0.1:{port}", ranks, rank, backend="gloo",
                 device=dev)
    configure_numerics()
    cfg = bench_cfg()
    res = {}

    # (b) dp=ranks x tp=1, this rank's block
    data = np.load(OUT_DIR / f"scale_rank{rank}.npz")
    mesh = D.global_mesh(tp=1)
    with count_collectives() as calls:
        out, counts, _ = counted_replay(
            "scale-out (b)", BATCH_PATH, (), lambda: None,
            lambda: D.replay_distributed(data["raw"], data["msk"], cfg,
                                         mesh=mesh))
    for n in POSE_NAMES + ("mapped",):
        res[f"b_{n}"] = D.gather_metric(getattr(out.outs, n), mesh)
    res.update(b_rate=out.per_chip_rate, b_seconds=out.elapsed_s,
               b_frames=out.frames_total, b_mesh=(mesh.dp, mesh.tp),
               b_launches=[counts[k] for k in KERNELS],
               b_calls=json.dumps(dict(calls)))

    # (e) weak scaling on submeshes of the first 1 and 2 ranks
    scaling = D.scaling_efficiency(cfg, dp_sizes=SCALE_SIZES)
    res.update(e_sizes=sorted(scaling["rates"]),
               e_rates=[scaling["rates"][s] for s in sorted(scaling["rates"])],
               e_efficiency=scaling["efficiency"])

    # (c) dp=1 x tp=ranks: the Jacobian rows split over every rank
    tp_data = np.load(OUT_DIR / "scale_tp.npz")
    tp_mesh = D.global_mesh(tp=ranks)
    run = PR.make_sharded_replay(tp_mesh, cfg)
    with count_collectives() as calls:
        tp_out, counts, seconds = counted_replay(
            "scale-out (c)", BATCH_PATH, (),
            lambda: run(tp_data["raw"][:, :3], tp_data["msk"][:, :3]),
            lambda: run(tp_data["raw"], tp_data["msk"]))
    for n in POSE_NAMES + ("mapped",):
        res[f"c_{n}"] = getattr(tp_out, n).cpu().numpy()
    res.update(c_seconds=seconds, c_mesh=(tp_mesh.dp, tp_mesh.tp),
               c_launches=[counts[k] for k in KERNELS],
               c_calls=json.dumps(dict(calls)))

    # (d) the dry run over every rank: the tiny configuration, then bench's
    dry, counts, _ = counted_replay(
        "scale-out (d)", ("select_walk",), (), lambda: None,
        lambda: dryrun_multichip(ranks))
    res.update(d_pose=np.stack([o.pose_integrated.cpu().numpy()
                                for o in dry]),
               d_launches=[counts[k] for k in KERNELS])

    np.savez(OUT_DIR / f"scale_out{rank}.npz", **res)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} of {ranks}: done", flush=True)
    return 0


def spawn_ranks(ranks: int) -> list:
    """Start `ranks` processes of scale_rank on a free loopback port and
    wait for them (RANK_TIMEOUT for all).  Raises, with the end of each
    rank's log, when one exits non-zero or time runs out; kills every
    rank it started."""
    port = free_port()
    logs = [OUT_DIR / f"scale_rank{r}.log" for r in range(ranks)]
    procs = []
    try:
        for r in range(ranks):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--rank",
                     str(r), "--ranks", str(ranks), "--port", str(port)],
                    stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
        deadline = time.monotonic() + RANK_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired as exc:
        raise AssertionError(
            f"phase 10: the ranks did not finish in {RANK_TIMEOUT} s:\n"
            + "\n".join(log.read_text()[-2000:] for log in logs)) from exc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(
            f"phase 10: rank exit codes {bad}:\n"
            + "\n".join(logs[r].read_text()[-3000:] for r, _ in bad))
    return [dict(np.load(OUT_DIR / f"scale_out{r}.npz"))
            for r in range(ranks)]


def scale_out_phase(dev, card: str, batch, raw, msk, default_outs):
    """Phase 10: the scale-out layer over torch.distributed and the
    one-frame entry, on the card.  batch: phase 6's (raw, mask, outputs)
    of bench.py's workload; raw, msk and default_outs: phase 4's sweeps
    and default replay.  Returns the launch counts of each run."""
    import torch.distributed as dist

    from loam_tpu_torch.config import LoamConfig
    from loam_tpu_torch.entry import bench_cfg, entry
    from loam_tpu_torch.parallel import distributed as D
    from torch_dcn_worker import count_collectives

    t_phase = time.perf_counter()
    braw, bmsk, bouts = batch
    want = {n: getattr(bouts, n).cpu().numpy()
            for n in POSE_NAMES + ("mapped",)}
    cfg = bench_cfg()
    launches, failed = {}, []

    # (a) a world of one rank over NCCL, all eight scenarios
    D.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                 device=dev)
    try:
        backend = dist.get_backend()
        with count_collectives() as calls:
            res, counts, _ = counted_replay(
                "scale-out (a)", BATCH_PATH, (), lambda: None,
                lambda: D.replay_distributed(braw, bmsk, cfg))
        gathered = {n: D.gather_metric(getattr(res.outs, n))
                    for n in POSE_NAMES}
    finally:
        dist.destroy_process_group()
    launches["scale-out a"] = counts
    same = all(torch.equal(getattr(res.outs, n), getattr(bouts, n))
               for n in POSE_NAMES + ("mapped",))
    rot, trans = pose_gap(gathered, want)
    print(f"scale-out (a): world 1 over {backend}, replay_distributed of "
          f"{BATCH_B} x {BATCH_F}: {res.per_chip_rate:.2f} frames/s a "
          f"rank ({res.elapsed_s:.3f} s); bit-equal to phase 6's batch: "
          f"{same}; gathered gap {rot:.3g} rad / {trans:.3g} m; "
          f"torch.distributed calls {dict(calls)}; launches {counts} "
          f"[{card}]", flush=True)
    if backend != "nccl" or not same or rot or trans:
        failed.append(f"(a) {backend}: bit-equal {same}, gap {rot}, {trans}")
    if dict(calls) != {"all_reduce": 1}:
        failed.append(f"(a) the dp path called {dict(calls)}, not the "
                      "timing all_reduce alone")

    # (b)-(e) in two ranks that share the card over gloo
    OUT_DIR.mkdir(exist_ok=True)
    half = BATCH_B // SCALE_RANKS
    for r in range(SCALE_RANKS):
        np.savez(OUT_DIR / f"scale_rank{r}.npz",
                 raw=braw[r * half:(r + 1) * half],
                 msk=bmsk[r * half:(r + 1) * half])
    np.savez(OUT_DIR / "scale_tp.npz", raw=braw[:SCALE_TP_B],
             msk=bmsk[:SCALE_TP_B])
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    ranks = spawn_ranks(SCALE_RANKS)
    t_ranks = time.perf_counter() - t_ranks
    r0 = ranks[0]
    for tag in ("b", "c", "d"):
        launches[f"scale-out {tag}"] = {
            k: int(sum(r[f"{tag}_launches"][i] for r in ranks))
            for i, k in enumerate(KERNELS)}

    # (b) dp=2 x tp=1
    equal = all(np.array_equal(r[f"b_{n}"], r0[f"b_{n}"]) for r in ranks
                for n in POSE_NAMES + ("mapped",))
    rot, trans = pose_gap({n: r0[f"b_{n}"] for n in POSE_NAMES}, want)
    cadence = np.array_equal(r0["b_mapped"], want["mapped"])
    rates = [float(r["b_rate"]) for r in ranks]
    print(f"scale-out (b): dp=2 x tp=1 over gloo, two ranks on one card, "
          f"{half} scenarios each: {rates[0]:.2f} frames/s a rank "
          f"({float(r0['b_seconds']):.3f} s, the slowest rank's); ranks "
          f"gathered identical poses: {equal}; gap to phase 6's batch "
          f"{rot:.3g} rad / {trans:.3g} m (gate {BATCH_ROT} / {BATCH_TRANS})"
          f"; cadence equal {cadence}; calls a rank "
          f"{[str(r['b_calls']) for r in ranks]}; launches "
          f"{launches['scale-out b']} [{card}]", flush=True)
    if not (equal and cadence and rot < BATCH_ROT and trans < BATCH_TRANS):
        failed.append(f"(b) identical {equal}, cadence {cadence}, gap "
                      f"{rot} rad, {trans} m")
    if len(set(rates)) != 1 or int(r0["b_frames"]) != BATCH_B * BATCH_F:
        failed.append(f"(b) the ranks' rates {rates}, frames "
                      f"{int(r0['b_frames'])}")

    # (c) dp=1 x tp=2
    equal = all(np.array_equal(r[f"c_{n}"], r0[f"c_{n}"]) for r in ranks
                for n in POSE_NAMES + ("mapped",))
    d = max(pose_gap({n: r0[f"c_{n}"] for n in POSE_NAMES},
                     {n: want[n][:SCALE_TP_B] for n in POSE_NAMES}))
    cadence = np.array_equal(r0["c_mapped"], want["mapped"][:SCALE_TP_B])
    calls = json.loads(str(r0["c_calls"]))
    per_frame = calls.get("all_reduce", 0) / BATCH_F
    c_rate = SCALE_TP_B * BATCH_F / float(r0["c_seconds"])
    print(f"scale-out (c): dp=1 x tp=2 over gloo, {SCALE_TP_B} scenarios, "
          f"rows split over the two ranks: ranks bit-equal {equal}; gap "
          f"to phase 6's batch {d:.3g} (gate {SCALE_TP_GATE}); cadence "
          f"equal {cadence}; {per_frame:.2f} all_reduces a frame "
          f"({calls}); {float(r0['c_seconds']):.3f} s = {c_rate:.2f} "
          f"frames/s against (b)'s {float(r0['b_seconds']):.3f} s for "
          f"{BATCH_B * BATCH_F} frames = "
          f"{BATCH_B * BATCH_F / float(r0['b_seconds']):.2f} frames/s; "
          f"launches {launches['scale-out c']} [{card}]", flush=True)
    if not (equal and cadence and d < SCALE_TP_GATE):
        failed.append(f"(c) ranks equal {equal}, cadence {cadence}, gap {d}")
    if set(calls) != {"all_reduce"} or per_frame < 1:
        failed.append(f"(c) torch.distributed calls {calls}")

    # (d) the dry run at tiny_cfg() and bench_cfg()
    finite = all(np.isfinite(r["d_pose"]).all() for r in ranks)
    print(f"scale-out (d): dryrun_multichip(2) (tp=2) at tiny_cfg() and "
          f"bench_cfg(): finite {finite}, poses {r0['d_pose'].tolist()} "
          f"[{card}]", flush=True)
    if not finite or r0["d_pose"].shape[0] != 2:
        failed.append("(d) the dry run's poses are not finite")

    # (e) weak scaling, printed only
    rates_e = dict(zip(r0["e_sizes"].tolist(), r0["e_rates"].tolist()))
    print(f"scale-out (e): scaling_efficiency at dp sizes {SCALE_SIZES} "
          f"(bench_cfg(), 2 random scenarios x 8 frames of 4096 points a "
          f"rank): frames/s a rank {rates_e}, efficiency "
          f"{float(r0['e_efficiency']):.4f}; the two ranks share one card, "
          f"so this measures contention, not scaling; no gate [{card}]",
          flush=True)

    # (f) the one-frame entry
    forward, args = entry()
    _, pose = forward(*args)
    tiny_ok = bool(torch.isfinite(pose).all())
    forward, (_, _, state0) = entry(cfg=LoamConfig())
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)

    def stepped():
        state, poses = state0, []
        for k in range(raw_t.shape[0]):
            state, p = forward(raw_t[k], msk_t[k], state)
            poses.append(p)
        return torch.stack(poses)

    _, required, forbidden = REPLAYS["default"]
    poses, counts, seconds = counted_replay(
        "entry", required, forbidden, lambda: None, stepped)
    launches["entry"] = counts
    d = np.abs(poses.double().cpu().numpy()
               - default_outs.pose_integrated.cpu().numpy())
    rot, trans = float(d[:, :3].max()), float(d[:, 3:].max())
    print(f"entry (f): forward at tiny_cfg() finite {tiny_ok}; stepped one "
          f"sweep at a time at LoamConfig() over phase 4's {FRAMES} sweeps "
          f"in {seconds:.3f} s = {FRAMES / seconds:.2f} frames/s; gap to "
          f"phase 4's default replay {rot:.3g} rad / {trans:.3g} m (gate "
          f"{BATCH_ROT} / {BATCH_TRANS}); launches {counts} [{card}]",
          flush=True)
    if not (tiny_ok and rot < BATCH_ROT and trans < BATCH_TRANS):
        failed.append(f"(f) tiny finite {tiny_ok}, gap {rot} rad, {trans} m")
    print(f"scale-out phase: {time.perf_counter() - t_phase:.1f} s, the "
          f"ranks {t_ranks:.1f} s [{card}]", flush=True)
    if failed:
        raise AssertionError(f"phase 10 failed its gates: {failed}")
    return launches


def long_config(hybrid: bool = False):
    """tests/test_long_sequence.py's CFG: loam_tpu's corrected-semantics
    mode (fresh Gauss-Newton rows, the whole upward walk) at rings of
    1024 and tables of 2^15 / 2^17; with hybrid, the
    map_exact_regather_every=5 cadence of its 100-frame gate."""
    from loam_tpu_torch.config import LoamConfig

    return dataclasses.replace(
        LoamConfig(), ring_width=1024, odom_y_scale=1.0,
        odom_weight_start_iter=0, corner_table_size=1 << 15,
        surf_table_size=1 << 17, odom_accumulate_rows=False,
        emulate_upward_scan_truncation=False,
        map_exact_regather_every=5 if hybrid else 1)


def accel_config():
    """tests/test_streaming_imu.py's CFG."""
    from loam_tpu_torch.config import LoamConfig

    return dataclasses.replace(
        LoamConfig(), ring_width=1024, odom_weight_start_iter=0,
        corner_table_size=1 << 14, surf_table_size=1 << 15,
        search_buckets=1 << 12, max_corner_from_map=8192,
        max_surf_from_map=16384)


def figure8_sequence():
    """The seed-9 figure-8 of tests/test_long_sequence._figure8, a NumPy
    copy: LONG_F sweeps of LONG_AZIMUTH azimuths after a static anchor
    pose, and the poses (LONG_F + 1, 6)."""
    from loam_tpu_torch.io import synth

    world = synth.make_world(seed=LONG_SEED)
    poses = synth.figure8_trajectory(LONG_F, speed=1.0)
    poses = np.vstack([poses[:1], poses])[: LONG_F + 1]
    sweeps = [synth.simulate_sweep(world, poses[k], poses[k + 1],
                                   n_azimuth=LONG_AZIMUTH,
                                   seed=LONG_SEED + k)
              for k in range(LONG_F)]
    return (np.stack([x for x, _ in sweeps]),
            np.stack([m for _, m in sweeps]), poses)


def drift(est, gt) -> tuple[float, float]:
    """The LOAM paper's drift, the final position error in % of the
    distance travelled, and the ATE (tests/test_long_sequence._drift_gate)
    of est (F, 3) against gt (F, 3)."""
    from loam_tpu_torch import metrics

    dist = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    final = float(np.linalg.norm(est[-1] - gt[-1]))
    return 100.0 * final / dist, metrics.ate_rmse(est, gt)


def accel_sequence(cfg):
    """tests/test_streaming_imu.py's scenario: ACCEL_F sweeps along the
    accelerating trajectory, the ground truth at each sweep's end, and
    the 200 Hz samples of its _global_imu as the raw IMU messages
    (t, rpy, acc), the body rotation formed in float32 as there."""
    from loam_tpu_torch.io import synth
    from loam_tpu_torch.utils import rotations
    from torch_parity import raw_imu

    world = synth.make_world(seed=ACCEL_SEED)
    pose_fn = synth.accel_trajectory(speed_amp=1.2, period=0.9)
    t_scans = cfg.scan_period * np.arange(ACCEL_F)
    n = cfg.max_points
    sweeps = [synth.simulate_sweep_traj(world, pose_fn, float(t0),
                                        n_azimuth=LONG_AZIMUTH,
                                        seed=ACCEL_SEED + k)
              for k, t0 in enumerate(t_scans)]
    raw = np.stack([x[:n] for x, _ in sweeps])
    msk = np.stack([m[:n] for _, m in sweeps])
    gt = np.stack([pose_fn(t + cfg.scan_period)[3:6] for t in t_scans])
    imu_t = np.arange(-0.05, ACCEL_F * cfg.scan_period + 0.05,
                      1.0 / IMU_RATE)
    h = 1e-3
    pyr, acc_int = [], []
    for t in imu_t:
        p = pose_fn(t)
        a_w = (pose_fn(t + h)[3:6] - 2 * p[3:6] + pose_fn(t - h)[3:6]) / h**2
        R = rotations.r_yxz(torch.tensor(p[:3], dtype=torch.float32))
        pyr.append(p[:3])
        acc_int.append(R.numpy().T @ a_w)
    rpy, acc = raw_imu(np.stack(pyr), np.stack(acc_int))
    return raw, msk, t_scans, gt, (imu_t, rpy, acc)


def long_phase(dev, card: str):
    """Phase 11: loam_tpu's long-horizon gates on the card, in its
    corrected-semantics mode: (a) the 200-frame figure-8, strict; (b)
    its first 100 frames at the hybrid cadence; (c) (a) split 120/80
    around a checkpoint; (d) the online engine on the accelerating
    trajectory, with and without the IMU.  Returns the launch counts of
    each run."""
    from loam_tpu_torch import checkpoint as CK, metrics, pipeline
    from loam_tpu_torch.runtime.streaming import StreamingEngine
    from torch_parity import paced_engine_run

    t_phase = time.perf_counter()
    launches, failed = {}, []
    t0 = time.perf_counter()
    raw, msk, poses = figure8_sequence()
    print(f"long: the figure-8, {LONG_F} sweeps of {LONG_AZIMUTH} azimuths "
          f"made in {time.perf_counter() - t0:.1f} s on the host",
          flush=True)
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    strict, hybrid = long_config(), long_config(hybrid=True)

    def gate(name, outs, frames, max_drift, max_ate, seconds, counts):
        est = outs.pose_integrated.cpu().numpy()
        finite = bool(np.isfinite(est).all())
        d, ate = drift(est[:, 3:6], poses[1:frames + 1, 3:6])
        print(f"long {name}: {frames} frames in {seconds:.3f} s = "
              f"{frames / seconds:.2f} frames/s; drift {d:.4f} % of the "
              f"distance (gate {max_drift}), ATE {ate:.4f} m (gate "
              f"{max_ate}), finite {finite}; launches {counts} [{card}]",
              flush=True)
        if not (finite and d < max_drift and ate < max_ate):
            failed.append(f"{name}: drift {d} %, ATE {ate} m, finite "
                          f"{finite}")

    # (a) the 200-frame figure-8, strict
    whole, launches["long strict"], secs = counted_replay(
        "long strict", LONG_PATH, ("knn_select",),
        lambda: pipeline.replay_sweeps(raw_t[:3], msk_t[:3], strict),
        lambda: pipeline.replay_sweeps(raw_t, msk_t, strict))
    gate("(a) strict", whole, LONG_F, LONG_DRIFT_GATE, LONG_ATE_GATE, secs,
         launches["long strict"])

    # (b) its first 100 frames at the hybrid cadence
    n = LONG_HYBRID_F
    outs, launches["long hybrid"], secs = counted_replay(
        "long hybrid", LONG_PATH + ("knn_select",), (),
        lambda: pipeline.replay_sweeps(raw_t[:3], msk_t[:3], hybrid),
        lambda: pipeline.replay_sweeps(raw_t[:n], msk_t[:n], hybrid))
    gate("(b) hybrid", outs, n, LONG_HYBRID_DRIFT_GATE, LONG_HYBRID_ATE_GATE,
         secs, launches["long hybrid"])

    # (c) (a) split around a checkpoint
    root = OUT_DIR / "long_checkpoint"
    shutil.rmtree(root, ignore_errors=True)
    ms = {}

    def split():
        s = LONG_SPLIT
        first, mid = pipeline.replay_sweeps(raw_t[:s], msk_t[:s], strict,
                                            return_state=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        CK.CheckpointManager(str(root)).save(s, mid, metadata={"frame": s})
        ms["save"] = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        restored, meta = CK.CheckpointManager(str(root)).restore(
            None, pipeline.PipelineState.create(strict, dev))
        torch.cuda.synchronize()
        ms["restore"] = 1e3 * (time.perf_counter() - t)
        if meta != {"frame": s}:
            raise AssertionError(f"long (c): metadata {meta}")
        rest = pipeline.replay_sweeps(raw_t[s:], msk_t[s:], strict,
                                      state0=restored)
        return torch.cat([first.pose_integrated, rest.pose_integrated])

    resumed, launches["long split"], secs = counted_replay(
        "long split", LONG_PATH, ("knn_select",), lambda: None, split)
    gap = float((resumed - whole.pose_integrated).abs().max())
    print(f"long (c) checkpoint: {LONG_F} frames split {LONG_SPLIT}/"
          f"{LONG_F - LONG_SPLIT}, {secs:.3f} s; save {ms['save']:.1f} ms, "
          f"restore {ms['restore']:.1f} ms; resumed pose_integrated "
          f"{gap:.3g} from (a)'s (gate {LONG_RESUME_GATE}); launches "
          f"{launches['long split']} [{card}]", flush=True)
    if not gap <= LONG_RESUME_GATE:
        failed.append(f"(c) resumed {gap} from the whole replay")

    # (d) the online engine on the accelerating trajectory
    cfg = accel_config()
    araw, amsk, t_scans, gt, imu = accel_sequence(cfg)
    ate = {}
    for name, samples in (("imu", imu), ("raw", None)):
        def run():
            eng = StreamingEngine(cfg, device=dev)
            eng.start()
            try:
                return paced_engine_run(eng, araw, amsk, t_scans, samples)[2]
            finally:
                eng.stop()

        key = f"online accel {name}"
        traj, launches[key], secs = counted_replay(
            key, ONLINE_PATH, ("knn_select",), lambda: None, run)
        finite = traj.shape[0] == ACCEL_F and bool(np.isfinite(traj).all())
        ate[name] = metrics.ate_rmse(traj[:, 3:6], gt)
        print(f"long (d) online, accelerating, {name}: {ACCEL_F} sweeps "
              f"paced in {secs:.3f} s; ATE {ate[name]:.4f} m vs the ground "
              f"truth; {traj.shape[0]} poses, finite {finite}; launches "
              f"{launches[key]} [{card}]", flush=True)
        if not finite:
            failed.append(f"(d) {name}: {traj.shape[0]} poses, finite "
                          f"{finite}")
    print(f"long (d): ATE with the IMU {ate['imu']:.4f} m (gate "
          f"{ACCEL_ATE_GATE}), without {ate['raw']:.4f} m [{card}]",
          flush=True)
    if not (ate["imu"] < ACCEL_ATE_GATE and ate["imu"] < ate["raw"] + 1e-6):
        failed.append(f"(d) ATE {ate['imu']} m with the IMU, {ate['raw']} m "
                      "without")
    print(f"long phase: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    if failed:
        raise AssertionError(f"phase 11 failed its gates: {failed}")
    return launches


def dense_config():
    """The dense cell's LoamConfig: rings of DENSE_AZIMUTH."""
    from loam_tpu_torch.config import LoamConfig

    return dataclasses.replace(LoamConfig(), ring_width=DENSE_AZIMUTH)


def dense_sweeps():
    """DENSE_F sweeps of the default cell's recipe at DENSE_AZIMUTH
    azimuths (NumPy)."""
    return make_sweeps(DENSE_F, DENSE_AZIMUTH)


def feature_overflow(raw_t, msk_t, cfg) -> dict:
    """What the caps of feature extraction cut from these sweeps: for each
    feature cloud, the most points a frame selects against its cap and
    the points cut over all frames; for the less-flat voxels, also each
    ring's against less_flat_ring_cap."""
    from loam_tpu_torch import frontend
    from loam_tpu_torch.ops import features as FT
    from loam_tpu_torch.ops.voxel import voxel_downsample

    sweep = frontend.ingest_sweep(raw_t, msk_t, cfg)
    W = cfg.ring_width
    curv, gap, pre, counts = FT.selection_inputs(sweep, cfg)
    labels, _ = FT.select_rings(curv.reshape(-1, W), gap.reshape(-1, W),
                                pre.reshape(-1, W), counts.reshape(-1), cfg)
    labels = labels.reshape(sweep.mask.shape)
    F = labels.shape[0]
    out = {}
    for name, sel, cap in (("sharp", labels == 2, cfg.max_sharp),
                           ("less_sharp", labels >= 1, cfg.max_less_sharp),
                           ("flat", labels == -1, cfg.max_flat)):
        n = sel.reshape(F, -1).sum(-1)
        out[name] = dict(most=int(n.max()), cap=cap,
                         cut=int((n - cap).clamp(min=0).sum()))
    idx = torch.arange(W, device=raw_t.device)
    selectable = (idx >= 5) & (idx <= counts[..., None] - 6) & sweep.mask
    keep = selectable & (labels <= 0)
    # the voxels of each ring uncapped (a cap of W cuts nothing)
    _, _, voxels = voxel_downsample(sweep.xyz, keep, cfg.less_flat_leaf, W)
    per_ring = voxels.sum(-1)
    kept = per_ring.clamp(max=cfg.less_flat_ring_cap)
    per_frame = kept.reshape(F, -1).sum(-1)
    out["less_flat_ring"] = dict(
        most=int(per_ring.max()), cap=cfg.less_flat_ring_cap,
        cut=int((per_ring - kept).sum()))
    out["less_flat"] = dict(
        most=int(per_frame.max()), cap=cfg.max_less_flat,
        cut=int((per_frame - cfg.max_less_flat).clamp(min=0).sum()))
    return out


def mode_replays(label, modes, sweeps, cfg0, started, dev, card: str):
    """sweeps (NumPy raw, mask) replayed on the card at cfg0 with each
    entry of `modes` (name -> (config changes, wrappers that must launch,
    wrappers that must not, {wrapper: [kernel instances that must
    launch]})), each integrated trajectory held within ATE_GATE of the
    NumPy oracle (started: start_oracle), after printing what the
    feature caps cut.  Returns (launch counts by mode, the gates failed,
    the outputs by mode)."""
    from loam_tpu_torch import metrics, pipeline

    raw, msk = sweeps
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    frames = raw.shape[0]
    print(f"{label}: {frames} sweeps of {raw.shape[1] // cfg0.n_scans} "
          f"azimuths at scan_period {cfg0.scan_period} s, "
          f"{int(msk.sum(1).max())} points a sweep at most, rings of "
          f"{cfg0.ring_width}; feature caps (most a frame or ring, cap, "
          f"points cut) {feature_overflow(raw_t, msk_t, cfg0)} [{card}]",
          flush=True)
    launches, results = {}, {}
    for name, (over, required, forbidden, instances) in modes.items():
        cfg = dataclasses.replace(cfg0, **over)
        (outs, state), counts, seconds = counted_replay(
            name, required, forbidden,
            lambda: pipeline.replay_sweeps(raw_t[:3], msk_t[:3], cfg),
            lambda: pipeline.replay_sweeps(raw_t, msk_t, cfg,
                                           return_state=True))
        missing = [(fn, key) for fn, keys in instances.items() for key in keys
                   if counts["instances"][fn].get(key, 0) <= 0]
        if missing:
            raise AssertionError(f"{name} replay never launched the kernel "
                                 f"instances {missing}")
        launches[name] = counts
        results[name] = (outs, state, seconds)
    oracle = wait_oracle(started)
    failed = []
    for name, (outs, state, seconds) in results.items():
        est = outs.pose_integrated.cpu().numpy()
        ate = metrics.ate_rmse(est[:, 3:6], oracle["integrated"][:, 3:6])
        cadence = np.array_equal(outs.mapped.cpu().numpy(), oracle["mapped"])
        print(f"replay {name}: {frames} frames in {seconds:.3f} s = "
              f"{frames / seconds:.2f} frames/s; integrated ATE vs golden "
              f"oracle {100 * ate:.4f} cm; mapping cadence equal: {cadence}; "
              f"local map overflow {int(state.map.local_map_overflow)}, NaN "
              f"skips {int(state.map.nan_skips)}; launches "
              f"{launches[name]} [{card}]", flush=True)
        if not (np.isfinite(est).all() and ate < ATE_GATE):
            failed.append(f"{name}: integrated ATE {ate:.4f} m")
    return launches, failed, {n: r[0] for n, r in results.items()}


def dense_phase(dev, card: str, started):
    """Phase 12, the dense cell: DENSE_F sweeps of a VLP-16 in dual-return
    mode replayed in rings of 3600 in three mapping modes (DENSE_MODES),
    each integrated trajectory within ATE_GATE of the NumPy oracle
    (started: start_oracle("dense")), each through its new kernel
    instances; then the command line at rings of 1800.  Prints the
    feature caps' and the map's overflow.  Returns the replays' launch
    counts."""
    t_phase = time.perf_counter()
    launches, failed, _ = mode_replays("dense", DENSE_MODES, dense_sweeps(),
                                       dense_config(), started, dev, card)

    # (d) the command line at rings of DENSE_CLI_WIDTH, as a subprocess
    out = OUT_DIR / "cli_dense"
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "loam_tpu_torch", "--synthetic",
           str(DENSE_CLI_F), "--ring-width", str(DENSE_CLI_WIDTH),
           "--golden-compare", "--out-dir", str(out)]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        failed.append(f"{' '.join(cmd[1:])} exited {done.returncode}:\n"
                      f"{done.stdout[-3000:]}\n{done.stderr[-5000:]}")
    else:
        from loam_tpu_torch.io import export

        verdict = cli_verdict(done.stdout)
        _, pos, _ = export.load_trajectory_tum(str(out / "integrated.tum"))
        n_map = export.load_cloud_ply(str(out / "map_surround.ply")).shape[0]
        if pos.shape != (DENSE_CLI_F, 3) or not np.isfinite(pos).all() \
                or n_map <= 0:
            failed.append(f"dense cli: {pos.shape[0]} poses, {n_map} map "
                          "points")
        print(f"dense cli: --synthetic {DENSE_CLI_F} --ring-width "
              f"{DENSE_CLI_WIDTH}: ATE vs golden oracle odometry "
              f"{verdict['ate_odom_cm']} cm, integrated "
              f"{verdict['ate_integrated_cm']} cm, pass {verdict['pass']}; "
              f"{n_map} map points; the command took {seconds:.1f} s "
              f"[{card}]", flush=True)
        if not verdict["pass"]:
            failed.append(f"dense cli failed its gate: {verdict}")
    print(f"dense phase: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    if failed:
        raise AssertionError(f"phase 12 failed its gates: {failed}")
    return launches


def rate5_config():
    """Phase 13 a's LoamConfig: rings of RATE5_AZIMUTH at RATE5_T."""
    return dataclasses.replace(dense_config(), ring_width=RATE5_AZIMUTH,
                               scan_period=RATE5_T)


def rate20_config():
    """Phase 13 b's LoamConfig: LoamConfig() at RATE20_T."""
    from loam_tpu_torch.config import LoamConfig

    return LoamConfig(scan_period=RATE20_T)


def rate5_sweeps():
    """RATE5_F sweeps of the default cell's recipe at RATE5_T, RATE5_AZIMUTH
    azimuths each (NumPy)."""
    return make_sweeps(RATE5_F, RATE5_AZIMUTH, RATE5_T)


def rate20_sweeps():
    """RATE20_F sweeps of the default cell's recipe at RATE20_T (NumPy)."""
    return make_sweeps(RATE20_F, RATE20_AZIMUTH, RATE20_T)


def rates_phase(dev, card: str, rate5, started5, started20):
    """Phase 13, the other rotation rates: (a) rate5 (rate5_sweeps) in
    RATE5_MODES, each through the walk's 8 words a lane, and (b)
    rate20_sweeps strict, each integrated trajectory within ATE_GATE of
    its NumPy oracle (started5, started20: start_oracle); (c) the golden
    IMU scenario at RATE5_T against the ground truth from the first
    sweep's end and a no-IMU rerun; (d) the streaming engine paced over
    (b)'s sweeps on its own clock, held to (b)'s replay by the engine's
    integration rule.  Returns the launch counts of every run."""
    from loam_tpu_torch import metrics, pipeline
    from loam_tpu_torch.imu import ImuStream
    from loam_tpu_torch.runtime.streaming import StreamingEngine
    from torch_parity import online_rule_replay, paced_engine_run

    t_phase = time.perf_counter()
    # (a) 300 RPM in dual-return mode, in phase 12's three mapping modes;
    # (b) 1200 RPM, strict
    launches, failed, _ = mode_replays("5 Hz", RATE5_MODES, rate5,
                                       rate5_config(), started5, dev, card)
    raw20, msk20 = rate20_sweeps()
    cfg20 = rate20_config()
    counts, failed20, outs = mode_replays("20 Hz", RATE20_MODES,
                                          (raw20, msk20), cfg20, started20,
                                          dev, card)
    launches.update(counts)
    failed += failed20

    # (c) the golden IMU scenario at 300 RPM: the horizon a sweep's end
    # plus 30 ms, as at 10 Hz; no oracle (it fixes 0.1 s in its IMU times)
    raw_i, msk_i, imu_t, rpy, acc, t_scans, pose_fn = imu_sequence(
        RATE_IMU_F, RATE5_T)
    stream = ImuStream(*(torch.tensor(a, device=dev) for a in frame_windows(
        imu_t, rpy, acc, t_scans, RATE5_T + IMU_HORIZON - 0.1)))
    ri_t, mi_t = torch.tensor(raw_i, device=dev), torch.tensor(msk_i,
                                                               device=dev)
    ti_t = torch.tensor(t_scans.astype(np.float32), device=dev)
    cfg_i = imu_config(RATE5_T)
    outs_i, launches["5 Hz imu"], seconds = counted_replay(
        "5 Hz imu", *IMU_PATH,
        lambda: pipeline.replay_sweeps(ri_t[:3], mi_t[:3], cfg_i,
                                       stream.map(lambda a: a[:3]),
                                       ti_t[:3]),
        lambda: pipeline.replay_sweeps(ri_t, mi_t, cfg_i, stream, ti_t))
    # the trajectory starts at the end of the first sweep, which the
    # ground truth of the 10 Hz gate (absolute positions) puts 0.20 m
    # along and at 5 Hz 0.30 m: held here from that pose, the absolute
    # figure printed beside
    est = outs_i.pose_integrated.cpu().numpy()[:, 3:6]
    plain = pipeline.replay_sweeps(ri_t, mi_t, cfg_i).pose_integrated
    plain = plain.cpu().numpy()[:, 3:6]
    gt = np.stack([pose_fn(t + RATE5_T)[3:6] for t in t_scans])
    ate_gt, ate_plain = (metrics.ate_rmse(e, gt - gt[0]) for e in (est, plain))
    moved = float(np.linalg.norm(est - plain, axis=1).max())
    print(f"replay 5 Hz imu: {RATE_IMU_F} sweeps of {IMU_AZIMUTH} azimuths "
          f"at scan_period {RATE5_T} s with {int(stream.mask.sum(1).max())} "
          f"IMU samples a window at most, {seconds:.3f} s = "
          f"{RATE_IMU_F / seconds:.2f} frames/s; ATE vs ground truth from "
          f"the first sweep's end {ate_gt:.4f} m (gate {IMU_GT_GATE}; "
          f"without the IMU {ate_plain:.4f} m), vs absolute ground truth "
          f"{metrics.ate_rmse(est, gt):.4f} m (the first sweep ends "
          f"{float(np.linalg.norm(gt[0])):.4f} m along, at 10 Hz "
          f"{float(np.linalg.norm(pose_fn(IMU_T0 + 0.1)[3:6])):.4f} m); "
          f"the no-IMU rerun "
          f"differs by {moved:.4f} m (gate > {IMU_MOVES}); launches "
          f"{launches['5 Hz imu']} [{card}]", flush=True)
    if not (np.isfinite(est).all() and ate_gt < IMU_GT_GATE
            and ate_gt < ate_plain and moved > IMU_MOVES):
        failed.append(f"5 Hz imu: ground-truth ATE {ate_gt:.4f} m (no IMU "
                      f"{ate_plain:.4f} m), moved {moved} m")

    # (d) the streaming engine over (b)'s sweeps on its own clock
    def run_d():
        eng = StreamingEngine(cfg20, device=dev)
        eng.start()
        try:
            return paced_engine_run(eng, raw20, msk20), eng._sweep_clock
        finally:
            eng.stop()

    ((odom, aft, integrated), clock), launches["online 20 Hz"], secs = \
        counted_replay("online 20 Hz", ONLINE_PATH, ("knn_select",),
                       lambda: None, run_d)
    ref, online = online_rule_replay(raw20, msk20, cfg20, dev)
    same = all(torch.equal(getattr(ref, n), getattr(outs["20 Hz"], n))
               for n in POSE_NAMES + ("mapped",))
    gaps = [np.abs(a.astype(np.float64) - b.cpu().numpy())
            for a, b in ((odom, ref.pose_odom), (aft, ref.pose_aft),
                         (integrated, online))]
    rot = max(float(g[:, :3].max()) for g in gaps)
    trans = max(float(g[:, 3:].max()) for g in gaps)
    print(f"online 20 Hz: {RATE20_F} sweeps in {secs:.3f} s = "
          f"{RATE20_F / secs:.2f} frames/s with a drain after each, the "
          f"engine's clock at {clock:.6f} s after them; largest gap to the "
          f"20 Hz replay by the integration rule {rot:.3g} rad, "
          f"{trans:.3g} m (the stepwise replay equals it: {same}); "
          f"launches {launches['online 20 Hz']} [{card}]", flush=True)
    if not (rot < BATCH_ROT and trans < BATCH_TRANS and same
            and abs(clock - RATE20_F * RATE20_T) < 1e-9):
        failed.append(f"online 20 Hz: {rot} rad, {trans} m from the replay, "
                      f"stepwise equal {same}, clock {clock} s")
    print(f"rates phase: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    if failed:
        raise AssertionError(f"phase 13 failed its gates: {failed}")
    return launches


def knob_rows(dev, raw, msk, rate5):
    """Phase 14's kernel rows, every output compared exactly: the walk at
    suppress_neighbors REACHES on every ring of phase 13 a's sweeps (W=7200,
    8 words a lane) and of phase 4's (B=1 x R=208, W=2048; reach 8 the
    row's own shape); the walk cut at SCAN_K candidates on the same rings;
    knn_topk_dyn K=5 on row 2's clouds (6000 x 50000 live) at pruned and
    at full windows (the row's own shape: map_knn_prune=False)."""
    from loam_tpu_torch import frontend
    from loam_tpu_torch.ops.cuda import knn_topk as KN

    def rings(sweeps, cfg):
        r, m = sweeps
        return walk_inputs(frontend.ingest_sweep(
            torch.tensor(r, device=dev), torch.tensor(m, device=dev), cfg),
            cfg)

    cells = (((rate5, rate5_config()), 8), (((raw, msk),
                                              replay_config("default")), 2))
    reach, depth = [], []
    for (sweeps, cfg), words in cells:
        for n in REACHES[::-1]:
            ring_set = rings(sweeps, dataclasses.replace(
                cfg, suppress_neighbors=n))
            reach.append(walk_shape(ring_set, 1, ring_set[0].shape[0],
                                    f",reach={n},words={words}"))
        ring_set = rings(sweeps, dataclasses.replace(
            cfg, corner_scan_k=SCAN_K, flat_scan_k=SCAN_K))
        depth.append(walk_shape(ring_set, 1, ring_set[0].shape[0],
                                f",depth={SCAN_K},words={words}"))
    rows = [walk_row("select_walk_reach", reach),
            walk_row("select_walk_depth", depth)]

    rng = np.random.default_rng(SEED)
    tq, tm = 256, 512
    q, ref, t_lo, t_hi = sorted_cloud(rng, dev, 1, 8192, 65536, 6000, 50000,
                                      1.0, tq, tm)
    full = KN.full_windows(1, 8192, 65536, tq, tm, dev)
    shapes = [windowed("knn_topk_dyn_full", 5, q, ref, 6000, 50000, t_lo,
                       t_hi, tq, tm, ",pruned"),
              windowed("knn_topk_dyn_full", 5, q, ref, 6000, 50000, *full,
                       tq, tm, ",full", plain_reps=3)]
    torch.cuda.synchronize()
    rows.append(dict(name="knn_topk_dyn_full", counter="knn_topk_dyn",
                     route="cuda", source="loam_tpu_torch/csrc/knn_topk.cu",
                     replaces="loam_tpu/ops/pallas/knn_topk.py:133",
                     **{**shapes[-1], "max_abs_err": max(
                         s["max_abs_err"] for s in shapes)},
                     other_shapes=shapes[:-1]))
    return rows


def knobs_phase(dev, card: str, raw, msk, rate5, default_outs, oracle):
    """Phase 14, the selection knobs and the unpruned mapping k-NN: the
    kernel rows of knob_rows, then phase 4's sweeps replayed strict at
    each KNOB_MODES entry.  suppress_neighbors=8 and the walks cut at
    SCAN_K are held to the ground truth (the golden oracle fixes a reach
    of 5 and walks whole subregions), map_knn_prune=False to the golden
    oracle (phase 4's), its cadence, and within 1e-4 rad / 1e-3 m of
    phase 4's strict replay (default_outs: pruning is exact within the
    1 m gate); every query block of the unpruned replay scans full
    windows, and no pruned replay's does.  Prints frame 0's feature
    counts at each reach.  Returns (kernel rows, launch counts)."""
    from loam_tpu_torch import frontend, metrics, pipeline
    from loam_tpu_torch.ops.cuda import knn_topk as KN
    from loam_tpu_torch.ops.features import extract_features

    t_phase = time.perf_counter()
    rows = knob_rows(dev, raw, msk, rate5)
    print_rows(rows, card)
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    base = replay_config("default")
    feats = {}
    for n in (base.suppress_neighbors,) + REACHES:
        cfg = dataclasses.replace(base, suppress_neighbors=n)
        f = extract_features(frontend.ingest_sweep(raw_t[:1], msk_t[:1],
                                                   cfg), cfg)
        feats[n] = [int(getattr(f, c).count().sum())
                    for c in ("sharp", "less_sharp", "flat")]
    print(f"knobs: frame 0's sharp, less-sharp and flat points by "
          f"suppress_neighbors {feats} [{card}]", flush=True)

    gt = cell_poses()[1:, 3:6]
    launches, failed = {}, []
    truth_default = metrics.ate_rmse(
        default_outs.pose_integrated.cpu().numpy()[:, 3:6], gt)
    real = KN.full_windows
    for name, (over, held) in KNOB_MODES.items():
        cfg = dataclasses.replace(base, **over)
        calls = []

        def counted_windows(*args):
            calls.append(1)
            return real(*args)

        def run():
            calls.clear()     # the warm-up's are not this run's
            return pipeline.replay_sweeps(raw_t, msk_t, cfg)

        KN.full_windows = counted_windows
        try:
            outs, launches[name], seconds = counted_replay(
                name, *KNOB_PATH,
                lambda: pipeline.replay_sweeps(raw_t[:3], msk_t[:3], cfg),
                run)
        finally:
            KN.full_windows = real
        dyn = launches[name]["knn_topk_dyn"]
        est = outs.pose_integrated.cpu().numpy()
        ate_gt = metrics.ate_rmse(est[:, 3:6], gt)
        line = (f"replay {name}: {FRAMES} frames in {seconds:.3f} s = "
                f"{FRAMES / seconds:.2f} frames/s; integrated ATE vs ground "
                f"truth {100 * ate_gt:.4f} cm (phase 4's strict "
                f"{100 * truth_default:.4f} cm)")
        ok = np.isfinite(est).all() and len(calls) == (
            dyn if name == "unpruned" else 0)
        if held == "truth":
            ok &= ate_gt < ATE_GATE
        else:
            ate = metrics.ate_rmse(est[:, 3:6], oracle["integrated"][:, 3:6])
            cadence = np.array_equal(outs.mapped.cpu().numpy(),
                                     oracle["mapped"])
            rot, trans = pose_gap(
                {n: getattr(outs, n).cpu().numpy() for n in POSE_NAMES},
                {n: getattr(default_outs, n).cpu().numpy()
                 for n in POSE_NAMES})
            line += (f", vs golden oracle {100 * ate:.4f} cm; mapping "
                     f"cadence equal: {cadence}; largest gap to phase 4's "
                     f"strict replay {rot:.3g} rad, {trans:.3g} m")
            ok &= (ate < ATE_GATE and cadence and rot < BATCH_ROT
                   and trans < BATCH_TRANS)
        line += (f"; full-window k-NN calls {len(calls)} of {dyn} "
                 f"launches; launches {launches[name]}")
        print(f"{line} [{card}]", flush=True)
        if not ok:
            failed.append(line)
    print(f"knobs phase: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    if failed:
        raise AssertionError(f"phase 14 failed its gates: {failed}")
    return rows, launches


def fetch(url: str) -> bytes:
    """GET over loopback."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


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
    if len(sys.argv) > 1:
        import argparse

        ap = argparse.ArgumentParser(
            description="a helper process of chip_smoke.py: phase 7's or "
                        "phase 12's oracle, or one rank of phase 10")
        ap.add_argument("--oracle", nargs=2, metavar=("NAME", "OUT"))
        ap.add_argument("--rank", type=int)
        ap.add_argument("--ranks", type=int)
        ap.add_argument("--port", type=int)
        a = ap.parse_args()
        if a.oracle:
            return oracle_process(*a.oracle)
        return scale_rank(a.rank, a.ranks, a.port)
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
    each = ", ".join(f"{n} {s:.1f} s" for n, s in _build.build_all.seconds.items())
    print(f"built {len(_build.KERNEL_SOURCES)} kernel libraries in {secs:.1f} s from "
          f"{Path(_build.CSRC).parent} (one nvcc each, all started together; "
          f"each nvcc ended at: {each})", flush=True)

    raw, msk = make_sweeps()
    imu = imu_inputs(dev)
    rate5 = rate5_sweeps()
    t_kernels = time.perf_counter()
    rows = kernel_phase(dev, raw, msk, replay_config("default"), imu,
                        dense_sweeps(), rate5)
    print_rows(rows, card)
    print(f"kernel phase: {time.perf_counter() - t_kernels:.1f} s [{card}]",
          flush=True)
    golden = start_oracle("golden")
    dense = start_oracle("dense")
    rates = start_oracle("rate5"), start_oracle("rate20")

    from golden.pipeline import run_pipeline

    oracle = run_pipeline(raw, msk)
    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    launches = {}
    replays = {}
    for name in REPLAYS:
        outs, counts, seconds = replay(name, raw_t, msk_t)
        launches[name] = counts
        replays[name] = outs
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
    launches["batch"], batch = batch_phase(dev, card)
    launches["golden"], launches["golden hybrid"] = golden_phase(
        dev, card, wait_oracle(golden))
    cli_synthetic_phase(card)
    launches["cli bag"], bag = cli_bag_phase(dev, card)
    checkpoint_phase(dev, card, bag)
    launches.update(online_phase(dev, card, raw, msk, replays["default"],
                                 oracle, bag))
    launches.update(scale_out_phase(dev, card, batch, raw, msk,
                                    replays["default"]))
    launches.update(long_phase(dev, card))
    launches.update(dense_phase(dev, card, dense))
    launches.update(rates_phase(dev, card, rate5, *rates))
    knob_kernels, knob_launches = knobs_phase(dev, card, raw, msk, rate5,
                                              replays["default"], oracle)
    rows += knob_kernels
    launches.update(knob_launches)

    # the windowed k-NN runs at k=5 in the strict replays, the entry and
    # the online engine only, at k=8 in the hybrid ones (phase 10's
    # replays too) and at k=16 in phase 12's and 13's; odom_corr walks
    # untruncated in phase 11's replays only; the walks and cell-bucket
    # selections of phase 12 and phase 13 a have rows of their own;
    # every other count sums over the replays
    k8_runs = ("hybrid", "batch", "golden hybrid", "cli bag", "scale-out a",
               "scale-out b", "scale-out c", "long hybrid")
    online = [n for n in launches if n.startswith("online")]
    dense = list(DENSE_MODES) + list(RATE5_MODES)
    # phase 14's walks and unpruned k-NN have rows of their own
    own_row = {"select_walk_reach": ("reach 8", "select_walk"),
               "select_walk_depth": ("scan 10", "select_walk"),
               "knn_topk_dyn_full": ("unpruned", "knn_topk_dyn")}
    for r in rows:
        if r["name"] in own_row:
            run, counter = own_row[r["name"]]
            r["launches"] = launches[run][counter]
        elif r["name"] == "knn_topk_dyn":
            r["launches"] = sum(
                launches[n]["knn_topk_dyn"] for n in
                ["default", "entry", "long strict", "long split",
                 "dense strict", "5 Hz strict", "20 Hz"] + online)
        elif r["name"] == "knn_topk_dyn_k8":
            r["launches"] = sum(launches[n]["knn_topk_dyn"] for n in k8_runs)
        elif r["name"] == "knn_topk_dyn_k16":
            r["launches"] = sum(launches[n]["knn_topk_dyn"]
                                for n in ("dense hybrid", "5 Hz hybrid"))
        elif r["name"] in ("odom_corr", "odom_corr_untruncated"):
            r["launches"] = sum(
                c["odom_corr"] for n, c in launches.items()
                if (n in UNTRUNCATED_RUNS) == (r["name"] != "odom_corr"))
        elif r["name"] == "select_walk_wide":
            r["launches"] = sum(launches[n]["select_walk"] for n in dense)
        elif r["name"] == "select_walk":
            r["launches"] = sum(c["select_walk"] for n, c in launches.items()
                                if n not in dense and n not in KNOB_MODES)
        elif r["name"] == "kselect_dense":
            r["launches"] = sum(launches[n]["knn_select"]
                                for n in ("dense cells", "5 Hz cells"))
        elif r["name"] == "kselect":
            r["launches"] = sum(c["knn_select"] for n, c in launches.items()
                                if n not in ("dense cells", "5 Hz cells"))
        else:
            r["launches"] = sum(c[r["counter"]] for c in launches.values())
        if r["launches"] <= 0:
            raise AssertionError(f"no replay launched {r['name']}")
        if r["name"] == "select_walk":
            # the batch's frontend walks its B x F x 16 rings in one
            # launch; the online engine one sweep's 16 rings a launch
            for shape in r["other_shapes"]:
                if shape["shape"].startswith(f"B={BATCH_B},"):
                    shape["launches"] = launches["batch"]["select_walk"]
                if shape["shape"].startswith("B=1,R=16,"):
                    shape["launches"] = sum(launches[n]["select_walk"]
                                            for n in online)
        if r["name"] == "select_walk_wide":
            # phase 12 walks at W=3600, phase 13 a at the row's own shape
            for shape in r["other_shapes"]:
                if shape["shape"].startswith("B=1,R=208,W=3600,"):
                    shape["launches"] = sum(launches[n]["select_walk"]
                                            for n in DENSE_MODES)

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
