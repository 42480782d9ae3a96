"""The port's small pose and metric helpers against loam_tpu's:
apply_pose_inverse, rpy_quaternion_wxyz, pose6_to_matrix and
trajectory_positions (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import metrics as JMet
from loam_tpu.utils import rotations as JR

from loam_tpu_torch import metrics as TMet
from loam_tpu_torch.utils import rotations as TR

torch.set_num_threads(1)


def _poses(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-np.pi, np.pi, (n, 3)),
                           rng.uniform(-60, 60, (n, 3))], 1).astype(np.float32)


def test_apply_pose_inverse_matches_and_round_trips():
    """R^T (p - t) as loam_tpu computes it, within 1e-6 m plus two
    float32 ulps of the largest |p - t| (the libraries' 3-term sums may
    differ by one), and apply_pose of it gives the points back; also
    with a leading scenario axis."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-60, 60, (200, 3)).astype(np.float32)
    poses = _poses()
    got = TR.apply_pose_inverse(torch.tensor(poses), torch.tensor(
        np.broadcast_to(pts, (len(poses),) + pts.shape).copy()))
    for i, pose in enumerate(poses):
        want = np.asarray(JR.apply_pose_inverse(jnp.asarray(pose),
                                                jnp.asarray(pts)))
        gap = np.abs(got[i].numpy() - want)
        scale = np.abs(pts - pose[3:]).max(-1, keepdims=True)
        assert (gap <= 1e-6 + 2 * np.spacing(scale)).all(), gap.max()
        one = TR.apply_pose_inverse(torch.tensor(pose), torch.tensor(pts))
        back = TR.apply_pose(torch.tensor(pose), one)
        np.testing.assert_allclose(back.numpy(), pts, atol=1e-4)


def test_rpy_quaternion_wxyz_matches():
    rng = np.random.default_rng(2)
    r, p, y = (rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
               for _ in range(3))
    got = TR.rpy_quaternion_wxyz(*(torch.tensor(a) for a in (r, p, y)))
    want = np.asarray(JR.rpy_quaternion_wxyz(*(jnp.asarray(a)
                                               for a in (r, p, y))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-6)


def test_pose6_to_matrix_matches():
    poses = _poses(8, seed=3)
    got = TR.pose6_to_matrix(torch.tensor(poses))
    assert got.shape == (8, 4, 4)
    for i, pose in enumerate(poses):
        want = np.asarray(JR.pose6_to_matrix(jnp.asarray(pose)))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-6)
        one = TR.pose6_to_matrix(torch.tensor(pose))
        np.testing.assert_allclose(one.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_trajectory_positions_matches(as_tensor):
    poses = _poses(10, seed=4)
    arg = torch.tensor(poses) if as_tensor else poses
    got = TMet.trajectory_positions(arg)
    assert isinstance(got, torch.Tensor) == as_tensor
    want = np.asarray(JMet.trajectory_positions(poses))
    np.testing.assert_array_equal(np.asarray(got), want)
