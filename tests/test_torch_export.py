"""The port's exporters (loam_tpu_torch/io/export.py) against
loam_tpu.io.export: for the same seeded poses and clouds the TUM and PLY
files are byte for byte the same, and both round-trip."""

import numpy as np
import pytest

from loam_tpu.io import export as JE

from loam_tpu_torch.io import export as TE


def _poses(seed):
    rng = np.random.default_rng(seed)
    poses = np.concatenate([rng.uniform(-np.pi, np.pi, (40, 3)),
                            rng.normal(scale=30.0, size=(40, 3))], 1)
    return 1e9 + np.arange(40) * 0.1, poses.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_tum_bytes_match_and_roundtrip(tmp_path, seed):
    stamps, poses = _poses(seed)
    TE.save_trajectory_tum(str(tmp_path / "port.tum"), stamps, poses)
    JE.save_trajectory_tum(str(tmp_path / "jax.tum"), stamps, poses)
    port = (tmp_path / "port.tum").read_bytes()
    assert port == (tmp_path / "jax.tum").read_bytes()
    assert port.count(b"\n") == 40
    t, pos, quat = TE.load_trajectory_tum(str(tmp_path / "port.tum"))
    np.testing.assert_allclose(t, stamps, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pos, poses[:, 3:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(quat, axis=1), 1.0, atol=1e-5)
    for a, b in zip((t, pos, quat),
                    JE.load_trajectory_tum(str(tmp_path / "jax.tum"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_ply_bytes_match_and_roundtrip(tmp_path, masked):
    rng = np.random.default_rng(2)
    xyz = rng.normal(scale=20.0, size=(500, 3)).astype(np.float32)
    mask = rng.uniform(size=500) > 0.4 if masked else None
    TE.save_cloud_ply(str(tmp_path / "port.ply"), xyz, mask)
    JE.save_cloud_ply(str(tmp_path / "jax.ply"), xyz, mask)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()
    back = TE.load_cloud_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(back, xyz if mask is None else xyz[mask])
    np.testing.assert_array_equal(
        back, JE.load_cloud_ply(str(tmp_path / "jax.ply")))
