"""Whether what the timed path produced is correct.

The sampled scenarios (drawn from the seed) of every pass of the window
against the frozen plain reference (reference/, NumPy) run on the same
sweeps: the frontend's feature points (the first and the last pass), and
the odometry, mapped and integrated poses and the mapping cadence (every
pass).

Every number is the largest over all sampled scenario-frames of all
passes (the feature number over the first and the last pass), so one
scenario that parts from the reference fails the run; the cadence is
compared exactly.  Each number that the cell's limits file
(perfbench/limits/<workload>.json) names is held to its limit; the
others are read and printed, not compared.  The reference runs once the window
has closed, in worker processes of one BLAS thread each.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

EXACT_CLASSES = ("sharp", "less_sharp", "flat")
# less_flat points are voxel centroids, summed in another order by each
# side: matched within 0.1 mm (float32 rounding of a centroid at 40 m is
# some microns, the voxel leaf 0.2 m)
CENTROID_TOL_M = 1e-4
POSES = (("odom", "pose_odom"), ("aft", "pose_aft"),
         ("integrated", "pose_integrated"))
NUMBERS = ("feat_mismatch", "odom_gap_m", "aft_gap_m", "integ_gap_m",
           "rot_gap_rad", "mapped_mismatch")
# pose_gaps' keys -> the numbers
GAPS = {"odom": "odom_gap_m", "aft": "aft_gap_m",
        "integrated": "integ_gap_m", "rot": "rot_gap_rad",
        "mapped": "mapped_mismatch"}
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def reference_job(raw, mask, tf32: bool):
    """The reference over one scenario's sweeps (F, N, 3) and masks; run
    in a worker process."""
    from pbench.reference.pipeline import run_pipeline

    return run_pipeline(raw, mask, tf32=tf32)


class References:
    """reference_job over jobs [(raw, mask, tf32), ...] (and those
    submitted later) in `workers` spawned processes of one BLAS thread
    each, started on entry so that other work can overlap them;
    results() gives them in job order.  Every worker has ended when the
    context is left."""

    def __init__(self, jobs, workers: int):
        self.jobs, self.workers = list(jobs), max(1, workers)

    def __enter__(self):
        saved = {v: os.environ.get(v) for v in THREAD_VARS}
        os.environ.update({v: "1" for v in THREAD_VARS})
        try:
            self.pool = ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=multiprocessing.get_context("spawn"))
            self.futures = []
            for job in self.jobs:
                self.submit(job)
        finally:
            for v, old in saved.items():
                if old is None:
                    os.environ.pop(v, None)
                else:
                    os.environ[v] = old
        return self

    def submit(self, job):
        self.futures.append(self.pool.submit(reference_job, *job))

    def results(self):
        return [f.result() for f in self.futures]

    def __exit__(self, *exc):
        for f in self.futures:
            f.cancel()
        self.pool.shutdown(wait=True)


def _rows(xyz) -> set:
    a = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    return set(a.view(np.dtype((np.void, 12))).ravel().tolist())


def _unmatched(a, b) -> int:
    """Points of a with no point of b within CENTROID_TOL_M."""
    from scipy.spatial import cKDTree

    if len(a) == 0:
        return 0
    if len(b) == 0:
        return len(a)
    d, _ = cKDTree(b).query(a, distance_upper_bound=CENTROID_TOL_M)
    return int(np.count_nonzero(~np.isfinite(d)))


def feature_mismatch(port: dict, ref: dict) -> float:
    """The share of one frame's reference feature points the port did not
    reproduce: sharp, less-sharp and flat points that are not in both
    sets bit for bit, and less-flat centroids on either side with no
    partner within CENTROID_TOL_M, over the reference's point count."""
    diff = total = 0
    for c in EXACT_CLASSES:
        diff += len(_rows(port[c]) ^ _rows(ref[c]))
        total += len(ref[c])
    a, b = port["less_flat"], ref["less_flat"]
    diff += _unmatched(a, b) + _unmatched(b, a)
    total += len(b)
    return diff / max(total, 1)


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def pose_gaps(port: dict, ref: dict) -> dict:
    """Per frame (F,): translation gaps (m) of the odometry, mapped and
    integrated poses, the largest rotation gap (rad) over the three, and
    whether the mapping cadence differs."""
    out = {}
    rot = 0.0
    for ref_key, port_key in POSES:
        p, r = port[port_key], ref[ref_key]
        out[ref_key] = np.linalg.norm(p[:, 3:6] - r[:, 3:6], axis=1)
        rot = np.maximum(rot, np.abs(_wrap(p[:, :3] - r[:, :3])).max(1))
    out["rot"] = rot
    out["mapped"] = (port["mapped"] != ref["mapped"]).astype(np.float64)
    return out


def compare(port_passes, features, refs, sample, limits):
    """The run's numbers and the sampled scenario-frames that put a
    number over its limit.

    port_passes: per pass a dict of (B, F, ...) NumPy pose arrays and
    `mapped`; features: pass index -> a dict class -> (xyz (S, F, n, 3),
    mask (S, F, n)) of the sampled scenarios (the first pass and the
    last); refs: the reference's result per sampled scenario; sample:
    the sampled scenario indices.  Returns (numbers {name: value},
    failed count): a scenario-frame fails where it puts a number the
    limits name over its limit."""
    per = dict.fromkeys(NUMBERS, 0.0)
    frames = {n: [] for n in NUMBERS}     # (gap, (pass, scenario, frame))
    for p, out in enumerate(port_passes):
        for s, b in enumerate(sample):
            ref = refs[s]
            gaps = pose_gaps({k: v[b] for k, v in out.items()}, ref)
            for name, gap in gaps.items():
                number = GAPS[name]
                # np.maximum keeps a NaN, so a NaN pose fails
                per[number] = float(np.maximum(per[number], gap.max()))
                frames[number] += [(g, (p, b, f)) for f, g in enumerate(gap)]
            feats = features.get(p)
            for f, ref_f in enumerate(ref["features"] if feats else ()):
                port_f = {c: xyz[s, f][m[s, f]]
                          for c, (xyz, m) in feats.items()}
                g = feature_mismatch(port_f, ref_f)
                per["feat_mismatch"] = max(per["feat_mismatch"], g)
                frames["feat_mismatch"].append((g, (p, b, f)))
    bad = {where for n in limits if per[n] > limits[n]
           for g, where in frames[n] if g > limits[n]}
    return per, len(bad)


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the cell's limits name within its limit (a cell
    compares the numbers whose two readings its control separates)."""
    return all(np.isfinite(numbers[n]) and numbers[n] <= limits[n]
               for n in limits)
