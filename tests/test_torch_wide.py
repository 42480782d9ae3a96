"""Ring widths that are not a multiple of 32, against loam_tpu (CPU, the
kernels' plain versions), and the configurations check_config accepts.

loam_tpu runs any ring_width; the port's selection walk packs ring
indices in 13 bits and bit-fields in ceil(W / 32) words with a ragged
last word.  Feature clouds follow tests/test_torch_frontend.py's
tolerances (integer outputs and gathers identical, less-flat centroids
within 1e-5), replays tests/test_torch_pipeline.py's (1e-4 rad /
1e-3 m a frame against the jitted replay, the cadence identical).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, pipeline as JP
from loam_tpu.ops import features as JFT
from loam_tpu.types import Sweep as JSweep

from loam_tpu_torch import cli as TC, pipeline as TP
from loam_tpu_torch.config import LoamConfig as PortConfig
from loam_tpu_torch.io import export
from loam_tpu_torch.ops import features as TFT
from loam_tpu_torch.types import Sweep

from torch_parity import make_sweeps, parity_cfg, pose_errors, to_port_cfg

torch.set_num_threads(1)

W = 600          # 18 3/4 words of 32 bits
FRAMES = 3


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def wide():
    """Three sweeps of 600 azimuths into rings of 600: full rings reach
    index W - 1, the last word's bit 23."""
    cfg = parity_cfg(ring_width=W)
    raw, msk, poses = make_sweeps(FRAMES, seed=3, n_azimuth=W)
    return cfg, raw, msk, poses


def test_extract_features_ragged_width_matches(wide):
    """Every feature cloud of three frames at W = 600 as loam_tpu's."""
    cfg, raw, msk, _ = wide
    js = jax.vmap(lambda x, m: JF.ingest_sweep(x, m, cfg))(
        jnp.asarray(raw), jnp.asarray(msk))
    assert int(np.asarray(js.mask).sum(-1).max()) > W - 32
    jf = jax.vmap(lambda s: JFT.extract_features(s, cfg))(
        JSweep(js.xyz, js.rel, js.mask))
    tf = TFT.extract_features(Sweep(_t(js.xyz), _t(js.rel), _t(js.mask)),
                              to_port_cfg(cfg))
    for name in ("sharp", "less_sharp", "flat", "full", "less_flat"):
        a, b = getattr(jf, name), getattr(tf, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        if name == "less_flat":
            np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz),
                                       atol=1e-5)
            np.testing.assert_allclose(b.rel.numpy(), np.asarray(a.rel),
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(b.xyz.numpy(), np.asarray(a.xyz))
            np.testing.assert_array_equal(b.rel.numpy(), np.asarray(a.rel))
    assert (tf.sharp.count() > 0).all() and (tf.flat.count() > 0).all()


def test_replay_ragged_width_matches_loam_tpu(wide):
    """A three-frame replay at W = 600: the cadence identical, every pose
    within 1e-4 rad / 1e-3 m of loam_tpu's jitted replay."""
    cfg, raw, msk, _ = wide
    jouts = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg)
    touts = TP.replay_sweeps(raw, msk, to_port_cfg(cfg), device="cpu")
    np.testing.assert_array_equal(touts.mapped.numpy(),
                                  np.asarray(jouts.mapped))
    assert touts.mapped.numpy().sum() == 1
    for name in ("pose_odom", "pose_aft", "pose_integrated"):
        rot, trans = pose_errors(getattr(touts, name).numpy(),
                                 getattr(jouts, name))
        assert rot < 1e-4 and trans < 1e-3, (name, rot, trans)
    assert np.isfinite(touts.pose_integrated.numpy()).all()


def test_cli_ragged_width_on_cpu(tmp_path):
    """`--synthetic 3 --ring-width 600 --device cpu`: the command line runs
    at a width that is not a multiple of 32 and writes, byte for byte, the
    trajectories of a replay of its sweeps (that replay is held to
    loam_tpu's above)."""
    argv = ["--synthetic", str(FRAMES), "--ring-width", str(W)]
    out = tmp_path / "out"
    assert TC.main(argv + ["--device", "cpu", "--out-dir", str(out)]) == 0
    args = TC.build_parser().parse_args(argv)
    cfg = TC._config(args)
    assert cfg.ring_width == W
    raw, msk, stamps, _ = TC._load_data(args, cfg)
    outs = TP.replay_sweeps(raw, msk, cfg, device="cpu")
    for name, field in (("odom", "pose_odom"), ("aft_mapped", "pose_aft"),
                        ("integrated", "pose_integrated")):
        ref = tmp_path / f"{name}.tum"
        export.save_trajectory_tum(str(ref), stamps,
                                   getattr(outs, field).numpy())
        assert (out / f"{name}.tum").read_bytes() == ref.read_bytes(), name
    t, pos, _ = export.load_trajectory_tum(str(out / "integrated.tum"))
    assert t.shape == (FRAMES,) and np.isfinite(pos).all()
    assert np.abs(pos[-1]).max() > 0.1     # 1 m/s for two sweeps


@pytest.mark.parametrize("over", [
    dict(ring_width=w) for w in (600, 1800, 2400, 3600, 4096, 8192)] + [
    dict(map_knn=k, **mode) for k in (3, 6)
    for mode in ({}, dict(map_exact_regather_every=5),
                 dict(map_exact_knn=False))] + [
    dict(map_exact_regather_every=5, map_exact_cache_k=c) for c in (12, 16)
] + [dict(map_exact_knn=False, knn_candidates=40)] + [
    dict(map_exact_knn=False, search_bucket_cap=c) for c in (40, 48)],
    ids=lambda over: ",".join(f"{k}={v}" for k, v in over.items()))
def test_check_config_accepts_what_loam_tpu_runs(over):
    """Ring widths, k and candidate counts that loam_tpu runs and the port
    once refused pass pipeline.check_config (it reads no device)."""
    TP.check_config(dataclasses.replace(PortConfig(), **over))
