"""The check's numbers at the cell's own batch and sample count: a
fault confined to some scenarios fails the run whichever of them the
seed samples."""

import numpy as np
import pytest
import torch

from pbench import cell, check, gen, spec

WORKLOAD = "vlp16_10hz.regress_b64"
SEEDS = [4_700_000_001 + 104_729 * i for i in range(12)]


def trajectories(seed, traffic, scan_period):
    """(B, F, 6) poses of the traffic's straight paths, drawn from the
    seed: stand-ins for the reference's and the program's."""
    g = torch.Generator().manual_seed(seed)
    B, F = int(traffic["scenarios"]), int(traffic["frames"])

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(B, generator=g, dtype=torch.float64)

    poses = gen.straight_poses(F, uniform(*traffic["speed_mps"]),
                               uniform(*traffic["yaw_rate_rps"]),
                               scan_period)
    return poses[:, 1:].numpy()


def as_outputs(poses, mapped):
    return {"pose_odom": poses, "pose_aft": poses,
            "pose_integrated": poses, "mapped": mapped}


def refs_of(poses, mapped, sample):
    return [{"odom": poses[b], "aft": poses[b], "integrated": poses[b],
             "mapped": mapped[b], "features": []} for b in sample]


def half_batch(poses):
    """The first half of the scenarios as they are, the rest their mean
    (the planted fault of test_perfbench_run)."""
    B = poses.shape[0]
    out = poses.copy()
    out[B // 2:] = poses[:B // 2].mean(0)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_half_batch_fails_at_the_cells_size(seed):
    real = spec.resolve(WORKLOAD)
    B = int(real.traffic["scenarios"])
    sample = cell.sampled(seed, B, int(real.traffic["check_scenarios"]))
    poses = trajectories(seed, real.traffic, real.config["scan_period"])
    mapped = np.ones(poses.shape[:2], bool)
    refs = refs_of(poses, mapped, sample)
    noise = np.random.default_rng(seed).normal(0.0, 1e-5, poses.shape)
    sound = check.compare([as_outputs(poses + noise, mapped)], {}, refs,
                          sample, real.limits)
    assert check.verdict(sound[0], real.limits), sound
    broken = check.compare([as_outputs(half_batch(poses + noise), mapped)],
                           {}, refs, sample, real.limits)
    assert not check.verdict(broken[0], real.limits), broken
    assert broken[1] > 0


def test_one_scenario_off_fails():
    """A single sampled scenario 5 cm off at one frame fails the run."""
    real = spec.resolve(WORKLOAD)
    B = int(real.traffic["scenarios"])
    sample = cell.sampled(SEEDS[0], B, int(real.traffic["check_scenarios"]))
    poses = trajectories(SEEDS[0], real.traffic, real.config["scan_period"])
    mapped = np.ones(poses.shape[:2], bool)
    off = poses.copy()
    off[sample[-1], 8, 3] += 0.05
    numbers, failed = check.compare([as_outputs(off, mapped)], {},
                                    refs_of(poses, mapped, sample), sample,
                                    real.limits)
    assert not check.verdict(numbers, real.limits) and failed == 1


def test_nan_pose_fails():
    real = spec.resolve(WORKLOAD)
    poses = trajectories(SEEDS[1], real.traffic, real.config["scan_period"])
    mapped = np.ones(poses.shape[:2], bool)
    sample = [0, 1]
    bad = poses.copy()
    bad[1, 3, 4] = np.nan
    numbers, _ = check.compare([as_outputs(bad, mapped)], {},
                               refs_of(poses, mapped, sample), sample,
                               real.limits)
    assert not check.verdict(numbers, real.limits)

