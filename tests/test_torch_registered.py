"""The registered full-res cloud (cfg.emit_registered,
/velodyne_cloud_registered, src/laserMapping.cpp:1060-1069) of
loam_tpu_torch against loam_tpu (CPU, plain kernel versions).

On a mapping frame the registered cloud is the odometry's end-projected
full cloud moved into the map frame with the refined pose, masked points
zeroed; on every other frame its mask is all False.  The masks are an
integer decision and must equal loam_tpu's frame for frame.  The xyz
gap is bounded by the gap of the two packages' poses at that frame:
a point at range r from the sensor moves by at most |dt| + (|drx| +
|dry| + |drz|) r when the pose moves by (dr, dt) (each elementary
rotation is 1-Lipschitz in its angle), plus XY_SLACK for float32
rounding at 40-60 m and the odometry's end projection.  A batch must
equal its single replays bit for bit, registered clouds included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import pipeline as JP
from loam_tpu.utils import rotations as JR

from loam_tpu_torch import pipeline as TP
from loam_tpu_torch.parallel import replay as TPR
from loam_tpu_torch.utils import rotations as TR

from torch_parity import make_sweeps, parity_cfg, to_port_cfg

torch.set_num_threads(1)

FRAMES = 4
XYZ_SLACK = 2e-5   # m
MODES = {
    "strict": {},
    "hybrid": dict(map_exact_regather_every=5),
    "cells": dict(map_exact_knn=False),
}


def test_registration_matches_apply_pose():
    """The port's registration of one cloud (points within 60 m) equals
    loam_tpu's apply_pose within 1e-6 m plus two float32 ulps of the
    point's largest coordinate: the two packages sum the 3-term products
    in other orders, which moves a coordinate of 40 m by an ulp
    (3.8e-6 m) or two."""
    rng = np.random.default_rng(0)
    pose = np.concatenate([rng.uniform(-0.5, 0.5, 3),
                           rng.uniform(-5, 5, 3)]).astype(np.float32)
    pts = rng.uniform(-60, 60, (4096, 3)).astype(np.float32)
    ref = np.asarray(JR.apply_pose(jnp.asarray(pose), jnp.asarray(pts)))
    got = TR.apply_pose(torch.tensor(pose), torch.tensor(pts)).numpy()
    err = np.abs(got.astype(np.float64) - ref).max(-1)
    ulps = np.spacing(np.abs(ref).max(-1))
    assert (err <= 1e-6 + 2 * ulps).all(), float((err / ulps).max())


@pytest.fixture(scope="module", params=list(MODES))
def replays(request):
    cfg = parity_cfg(emit_registered=True, **MODES[request.param])
    raw, msk, _ = make_sweeps(FRAMES, seed=3)
    jouts = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg)
    touts = TP.replay_sweeps(raw, msk, to_port_cfg(cfg), device="cpu")
    return cfg, raw, msk, jouts, touts


def test_registered_matches_loam_tpu(replays):
    _, _, _, jouts, touts = replays
    mapped = touts.mapped.numpy()
    np.testing.assert_array_equal(mapped, np.asarray(jouts.mapped))
    assert mapped.sum() == 2
    jmask = np.asarray(jouts.registered.mask)
    tmask = touts.registered.mask.numpy()
    np.testing.assert_array_equal(tmask, jmask)
    counts = tmask.sum(-1)
    assert (counts[mapped] > 1000).all() and (counts[~mapped] == 0).all()
    txyz = touts.registered.xyz.numpy().astype(np.float64)
    jxyz = np.asarray(jouts.registered.xyz, np.float64)
    assert (txyz[~tmask] == 0).all()
    for k in np.nonzero(mapped)[0]:
        gap = np.abs(touts.pose_integrated[k].numpy().astype(np.float64)
                     - np.asarray(jouts.pose_integrated[k], np.float64))
        rng = np.linalg.norm(
            txyz[k] - touts.pose_integrated[k, 3:].numpy(), axis=-1)
        bound = np.linalg.norm(gap[3:]) + gap[:3].sum() * rng + XYZ_SLACK
        err = np.linalg.norm(txyz[k] - jxyz[k], axis=-1)
        assert (err <= bound).all(), (k, float(err.max()),
                                      float(bound[err.argmax()]))


def test_batched_registered_equals_single_replays(replays):
    cfg, raw, msk, _, touts = replays
    other = make_sweeps(FRAMES, seed=6, speed=0.8, yaw_rate=-0.12)
    pcfg = to_port_cfg(cfg)
    batch = TPR.batched_replay(np.stack([raw, other[0]]),
                               np.stack([msk, other[1]]), pcfg,
                               device="cpu")
    single1 = TP.replay_sweeps(other[0], other[1], pcfg, device="cpu")
    for b, one in enumerate((touts, single1)):
        for name in ("pose_integrated", "mapped"):
            assert torch.equal(getattr(batch, name)[b], getattr(one, name))
        for name in ("xyz", "rel", "mask"):
            assert torch.equal(getattr(batch.registered, name)[b],
                               getattr(one.registered, name)), (b, name)
