"""A whole run on the CPU at a small size, past the look for a card: the
result line's keys, `correct` on the unbroken path, and `correct` false
with the timed path broken underneath, once for each fault a replay
cell can have (one card: no exchange between chips to leave out).  Then
the control, the reference at TF32 precision in the program's place,
against the same limits."""

import contextlib
import json
import time

import numpy as np
import pytest
import torch

from loam_tpu_torch import pipeline
from loam_tpu_torch.parallel import replay
from loam_tpu_torch.types import tree_map
from pbench import cell, check, gen, spec

WORKLOAD = "vlp16_10hz.regress_b64"
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


def small_cell():
    """The cell's limits and traffic recipe at 600 azimuths, B=2, F=3."""
    real = spec.resolve(WORKLOAD)
    config = dict(azimuths=600, scan_period=0.1, ring_width=1024,
                  corner_table_size=1 << 13, surf_table_size=1 << 14,
                  search_buckets=1 << 10)
    traffic = dict(real.traffic, scenarios=2, frames=3, check_scenarios=2)
    return spec.Cell("small", 1, config, traffic, real.limits,
                     real.end_to_end, [])


def run_small(seed=3_000_000_005):
    return cell.run(small_cell(), seed, 0.0, False, "cpu",
                    time.perf_counter(), "cpu", workers=2)


@contextlib.contextmanager
def patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def state_unchanged(orig):
    def step(state, *args, **kwargs):
        _, out = orig(state, *args, **kwargs)
        return state, out
    return step


def half_batch(orig):
    """The first half of the scenarios replayed, the rest filled with
    their mean."""
    def replay_batch(feats, cfg, state, *args, **kwargs):
        B = feats.sharp.mask.shape[0]
        h = max(1, B // 2)
        outs, final = orig(feats.map(lambda t: t[:h]), cfg,
                           tree_map(lambda t: t[:h], state), *args,
                           **kwargs)

        def fill(t):
            rest = t.double().mean(0, keepdim=True).expand(
                (B - h,) + t.shape[1:]).to(t.dtype)
            return torch.cat([t, rest])
        return tree_map(fill, outs), final
    return replay_batch


def altered_answer(orig):
    """Each scenario's odometry pose moved 5 cm at one frame."""
    def replay_batch(feats, cfg, state, *args, **kwargs):
        outs, final = orig(feats, cfg, state, *args, **kwargs)
        k = outs.pose_odom.shape[1] // 2
        outs.pose_odom[:, k, 3] += 0.05
        return outs, final
    return replay_batch


FAULTS = {
    "state_unchanged": (pipeline, "_step", state_unchanged),
    "half_batch": (replay, "replay_batch", half_batch),
    "altered_answer": (replay, "replay_batch", altered_answer),
}


def test_unbroken_run():
    result = run_small()
    assert list(result) == RESULT_KEYS
    json.dumps(result)
    assert set(result["metrics"]) == {"frames_per_s", "peak_mem_gib",
                                      "setup_s"}
    assert result["attempted"] == 2 * 3 and result["failed"] == 0
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(fault):
    module, name, make = FAULTS[fault]
    with patched(module, name, make):
        result = run_small()
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


def test_control_is_not_correct():
    """The reference at TF32 precision in the program's place fails the
    cell's limits (calibrate.py reads it at the cell's size on the
    card)."""
    import calibrate

    small = small_cell()
    raw, mask = gen.make_traffic(3_000_000_007, small.traffic,
                                       small.config, "cpu")
    jobs = [(raw[b].numpy(), mask[b].numpy(), tf32)
            for b in range(2) for tf32 in (False, True)]
    with check.References(jobs, 4) as references:
        results = references.results()
    numbers = calibrate.control_numbers(results[::2], results[1::2])
    assert all(np.isfinite(v) for v in numbers.values())
    assert not check.verdict(numbers, small.limits), numbers
