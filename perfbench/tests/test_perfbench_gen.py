"""The on-card generator, run on the CPU, against
loam_tpu_torch.io.synth for one seed."""

import numpy as np
import torch

from loam_tpu_torch.io import synth
from pbench import gen

SEED = 2_900_000_123


def _synth_uniforms(seed, n_pillars=6, n_boxes=4):
    """make_world's uniform draws, in its order."""
    rng = np.random.default_rng(seed)
    up = np.array([[rng.random() for _ in range(3)]
                   for _ in range(n_pillars)])
    ub = np.array([[rng.random() for _ in range(4)] for _ in range(n_boxes)])
    return up, ub


def test_world_matches_make_world():
    up, ub = _synth_uniforms(SEED)
    bmin, bmax = gen.boxes_from_uniforms(torch.tensor(up), torch.tensor(ub))
    world = synth.make_world(SEED)
    np.testing.assert_array_equal(bmin.numpy(), world.boxes_min)
    np.testing.assert_array_equal(bmax.numpy(), world.boxes_max)


def test_poses_match_straight_trajectory():
    for speed, yaw_rate, period in ((0.93, -0.12, 0.2), (1.4, 0.15, 0.1)):
        want = synth.straight_trajectory(17, speed=speed, yaw_rate=yaw_rate,
                                         scan_period=period)
        got = gen.straight_poses(17, torch.tensor([speed], dtype=gen.F64),
                                 torch.tensor([yaw_rate], dtype=gen.F64),
                                 period)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sweeps_match_simulate_sweep():
    """Every point within float32 rounding of synth's, the masks equal
    (synth's noise set to 0; the generator's noise is its own draw)."""
    world = synth.make_world(SEED)
    poses = synth.straight_trajectory(6, speed=1.1, yaw_rate=0.1)
    poses = np.vstack([poses[:1], poses])[:7]
    dirs, frac = gen.ray_directions(360, "cpu")
    for k in (0, 3, 5):
        want, want_m = synth.simulate_sweep(world, poses[k], poses[k + 1],
                                            n_azimuth=360, noise=0.0)
        got, got_m = gen.cast_sweeps(
            torch.tensor(world.boxes_min), torch.tensor(world.boxes_max),
            torch.tensor(poses[k:k + 1]), torch.tensor(poses[k + 1:k + 2]),
            dirs, frac, torch.zeros(1, dirs.shape[0], dtype=gen.F64))
        np.testing.assert_array_equal(got_m[0].numpy(), want_m)
        np.testing.assert_allclose(got[0].numpy()[want_m], want[want_m],
                                   rtol=1e-6, atol=1e-6)


def test_traffic_is_a_function_of_the_seed():
    traffic = dict(scenarios=2, frames=3, pillars=6, boxes=4,
                   speed_mps=[0.6, 1.4], yaw_rate_rps=[-0.15, 0.15],
                   range_noise_m=0.005)
    sensor = dict(azimuths=120, scan_period=0.1)
    a = gen.make_traffic(3_000_000_001, traffic, sensor, "cpu")
    b = gen.make_traffic(3_000_000_001, traffic, sensor, "cpu")
    c = gen.make_traffic(3_000_000_002, traffic, sensor, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (2, 3, 120 * 16, 3) and a[0].dtype == torch.float32
    assert a[1].shape == (2, 3, 120 * 16) and a[1].any()


def _distance_to_solids(pos, bmin, bmax):
    """Least distance from positions (B, P, 3) to each solid (B, n)."""
    gap = torch.maximum(torch.maximum(bmin[:, None] - pos[:, :, None],
                                      pos[:, :, None] - bmax[:, None]),
                        torch.zeros((), dtype=gen.F64))
    return gap.norm(dim=-1).amin(1)


def test_keep_clear_moves_only_the_solids_near_the_path():
    g = torch.Generator().manual_seed(7)
    B, F = 256, 17
    bmin, bmax = gen.boxes_from_uniforms(
        torch.rand((B, 6, 3), generator=g, dtype=gen.F64),
        torch.rand((B, 4, 4), generator=g, dtype=gen.F64))
    speed = 0.6 + 0.8 * torch.rand(B, generator=g, dtype=gen.F64)
    yaw = -0.15 + 0.3 * torch.rand(B, generator=g, dtype=gen.F64)
    poses = gen.straight_poses(F, speed, yaw, 0.1)
    t = torch.linspace(0, 1, 9, dtype=gen.F64)
    pos = (poses[:, :-1, None, 3:] + t[:, None] * (
        poses[:, 1:, None, 3:] - poses[:, :-1, None, 3:])).reshape(B, -1, 3)
    before = _distance_to_solids(pos, bmin, bmax)
    cmin, cmax = gen.keep_clear(bmin, bmax, poses, 1.0)
    after = _distance_to_solids(pos, cmin, cmax)
    assert (before < 1.0).any()
    assert (after >= 1.0 - 1e-9).all()
    kept = before >= 1.0 + 3.0     # far from the path: never moved
    assert torch.equal(cmin[kept], bmin[kept])
    torch.testing.assert_close(cmax - cmin, bmax - bmin, rtol=0,
                               atol=1e-12)
    assert torch.equal(cmin[..., 1:], bmin[..., 1:])


def test_traffic_kept_clear_loses_no_return():
    traffic = dict(scenarios=12, frames=3, pillars=6, boxes=4,
                   speed_mps=[0.6, 1.4], yaw_rate_rps=[-0.15, 0.15],
                   range_noise_m=0.005, clearance_m=1.0)
    sensor = dict(azimuths=90, scan_period=0.1)
    for seed in (3_000_000_001, 4_500_104_730, 2**31 + 5):
        raw, mask = gen.make_traffic(seed, traffic, sensor, "cpu")
        assert mask.all()
        assert raw.norm(dim=-1).amin() > 0.99
