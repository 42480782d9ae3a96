"""The selection walk's suppression reach past 7 and the unpruned mapping
k-NN: loam_tpu_torch against loam_tpu (CPU, plain kernel versions).

A pick suppresses up to suppress_neighbors points a side, fewer where a
gap breaks the run.  The walk's meta word holds each reach in 5 bits and
the walk marks a span in at most two 32-bit words, so the port takes
reaches up to select_walk.MAX_REACH = 16 and refuses more before any
frame (tests/torch_parity.REFUSED).  Labels and the sharp, less-sharp,
flat and full clouds must be identical; the less-flat voxel means within
1e-5 (the cumsum grouping of tests/test_torch_frontend.py); whole
replays keep the cadence and hold 1e-4 rad / 1e-3 m
(tests/test_torch_pipeline.py says why not bit for bit).

map_knn_prune=False gives the exact mapping k-NN every reference tile
(knn_topk.full_windows); pruning is exact within the 1 m gate, so the
unpruned replay holds loam_tpu's as the pruned one does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, pipeline as JP
from loam_tpu.ops import features as JFT
from loam_tpu.types import Sweep as JSweep

from loam_tpu_torch import pipeline as TP
from loam_tpu_torch.ops import features as TFT
from loam_tpu_torch.ops.cuda import select_walk as SW
from loam_tpu_torch.types import Sweep

from torch_parity import (make_sweeps, parity_cfg, pose_errors, serial_walk,
                          to_port_cfg, walk_kwargs, walk_meta_case)

torch.set_num_threads(1)

POSES = ("pose_odom", "pose_aft", "pose_integrated")


def _t(a):
    return torch.tensor(np.asarray(a))


def _ingest(cfg, frames):
    raw, msk, _ = make_sweeps(frames, seed=3)
    return raw, msk, jax.vmap(lambda x, m: JF.ingest_sweep(x, m, cfg))(
        jnp.asarray(raw), jnp.asarray(msk))


def _assert_replays_match(cfg, frames):
    raw, msk, _ = make_sweeps(frames, seed=3)
    jouts = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg)
    touts = TP.replay_sweeps(raw, msk, to_port_cfg(cfg), device="cpu")
    np.testing.assert_array_equal(touts.mapped.numpy(),
                                  np.asarray(jouts.mapped))
    for name in POSES:
        rot, trans = pose_errors(getattr(touts, name).numpy(),
                                 getattr(jouts, name))
        assert rot < 1e-4 and trans < 1e-3, (name, rot, trans)
    return touts


@pytest.mark.parametrize("reach", [7, 8, 16])
def test_selection_labels_match_select_ring_at_reach(reach):
    """The walk's labels equal loam_tpu's select_ring on every ring of a
    sweep (16 rings of 512) at suppress_neighbors 7, 8 and 16; a reach
    of 8 or more overflowed the old 3-bit fields into the next one."""
    cfg = parity_cfg(suppress_neighbors=reach)
    _, _, js = _ingest(cfg, 1)
    tcfg = to_port_cfg(cfg)
    tsw = Sweep(_t(js.xyz), _t(js.rel), _t(js.mask))
    curv, gap, pre, counts = TFT.selection_inputs(tsw, tcfg)
    W = cfg.ring_width
    lab_t, pick_t = TFT.select_rings(curv.reshape(-1, W), gap.reshape(-1, W),
                                     pre.reshape(-1, W), counts.reshape(-1),
                                     tcfg)
    lab_j, pick_j = jax.vmap(
        lambda x, c, g, p, n: JFT.select_ring(x, c, g, p, n, cfg)
    )(jnp.asarray(js.xyz).reshape(-1, W, 3),
      *(jnp.asarray(a.numpy()).reshape(-1, W) for a in (curv, gap, pre)),
      jnp.asarray(counts.numpy()).reshape(-1))
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_array_equal(pick_t.numpy(), np.asarray(pick_j))
    # the reach is reached: some point's up and down runs are that long
    up, dn = TFT._suppress_reach(gap, tcfg.suppress_gap_sq, reach)
    assert int(up.max()) == reach and int(dn.max()) == reach
    assert (lab_t.numpy() == 2).sum() >= cfg.n_scans


def test_extract_features_matches_at_reach_8():
    """Three frames at suppress_neighbors=8: every feature cloud as
    loam_tpu's (less-flat within 1e-5, as at the default)."""
    cfg = parity_cfg(suppress_neighbors=8)
    _, _, js = _ingest(cfg, 3)
    jf = jax.vmap(lambda s: JFT.extract_features(s, cfg))(
        JSweep(js.xyz, js.rel, js.mask))
    tf = TFT.extract_features(Sweep(_t(js.xyz), _t(js.rel), _t(js.mask)),
                              to_port_cfg(cfg))
    for name in ("sharp", "less_sharp", "flat", "full", "less_flat"):
        a, b = getattr(jf, name), getattr(tf, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        tol = 1e-5 if name == "less_flat" else 0
        np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(b.rel.numpy(), np.asarray(a.rel),
                                   rtol=0, atol=tol)
    assert (tf.sharp.count() > 0).all() and (tf.flat.count() > 0).all()


def test_replay_at_reach_8_matches_loam_tpu():
    """A 3-frame replay at suppress_neighbors=8: the same cadence, poses
    within 1e-4 rad / 1e-3 m."""
    _assert_replays_match(parity_cfg(suppress_neighbors=8), 3)


def test_walk_meta_roundtrip_at_the_largest_reach():
    """pack_walk_meta and the plain walk's unpack give back every field,
    reaches up to MAX_REACH beside the largest ring index; a pick at
    MAX_REACH suppresses 2 * MAX_REACH + 1 points."""
    rng = np.random.default_rng(0)
    n = 4096
    ind = torch.tensor(rng.integers(0, SW.MAX_W, n))
    ind[:2] = SW.MAX_W - 1
    up, dn = (torch.tensor(rng.integers(0, SW.MAX_REACH + 1, n))
              for _ in range(2))
    up[0] = dn[0] = up[1] = SW.MAX_REACH
    valid, qual = (torch.tensor(rng.uniform(size=n) < 0.5) for _ in range(2))
    valid[0] = qual[0] = True
    got = SW.unpack_walk_meta(SW.pack_walk_meta(ind, valid, qual, up,
                                                dn).long())
    for a, b in zip(got, (ind, up, dn, valid, qual)):
        assert torch.equal(a, b.to(a.dtype))

    W, c = 512, 200
    meta = SW.pack_walk_meta(*(torch.tensor([v]) for v in (
        c, True, True, SW.MAX_REACH, SW.MAX_REACH)))
    fill = SW.pack_walk_meta(*(torch.tensor([v]) for v in (0, False, False,
                                                             0, 0)))
    cm = torch.cat([meta, fill.expand(W - 1)])[None, None]
    fm = fill.expand(W)[None, None].contiguous()
    picked0 = SW.pack_bits(torch.zeros(1, 1, W, dtype=torch.bool))
    sharp, _, _, picked = SW.select_walk_plain(
        cm, fm, picked0, n_sub=1, subw=W, W=W, max_sharp=2,
        max_less_sharp=20, max_flat=4)
    span = SW.unpack_bits(picked, W)[0, 0]
    assert torch.equal(torch.nonzero(span).flatten(),
                       torch.arange(c - SW.MAX_REACH, c + SW.MAX_REACH + 1))
    assert SW.unpack_bits(sharp, W)[0, 0, c]


@pytest.mark.parametrize("W,depth", [(512, 0), (512, 10), (3600, 0)])
def test_select_walk_plain_matches_serial_walk_at_the_largest_reach(W,
                                                                    depth):
    """The plain walk equals the one-candidate-at-a-time NumPy walk on
    constructed meta with reaches up to MAX_REACH (spans of 33 bits
    across words and subregions)."""
    B, R = 2, 6
    cm, fm, p0, _ = walk_meta_case(B, R, W, seed=W + depth,
                                   reach=SW.MAX_REACH)
    kw = walk_kwargs(to_port_cfg(parity_cfg()), W, depth, depth)
    got = SW.select_walk_plain(_t(cm), _t(fm), SW.pack_bits(_t(p0)), **kw)
    want, _ = serial_walk(cm.reshape(B * R, -1), fm.reshape(B * R, -1),
                          p0.reshape(B * R, W), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            SW.unpack_bits(g, W).numpy().reshape(B * R, W), w)
    assert want[0].any() and want[2].any()


def test_unpruned_mapping_knn_matches_loam_tpu():
    """map_knn_prune=False through five frames (two mapping frames, the
    second a solve): the same cadence and poses as loam_tpu's within
    1e-4 rad / 1e-3 m, and the solve moved the mapped pose."""
    touts = _assert_replays_match(parity_cfg(map_knn_prune=False), 5)
    mapped = np.flatnonzero(touts.mapped.numpy())
    assert len(mapped) == 2
    # the aft-mapped pose changes only where a frame solves: the first
    # mapping frame has no map and keeps the identity, the second moves it
    first, second = touts.pose_aft.numpy()[mapped]
    assert not first.any()
    assert np.isfinite(second).all() and np.abs(second[3:]).max() > 0.1
