"""Every LoamConfig knob the port reads, held to loam_tpu stage by stage
(CPU, plain kernel versions): the feature knobs here, the odometry knobs
in tests/test_torch_knobs_odom.py and the mapping and map-store knobs in
tests/test_torch_knobs_map.py (loam_tpu run op by op costs a file of its
own a stage); test_every_knob_is_held checks that the three files cover
every knob.

Each case sets one knob to a value other than its default that changes
the stage's outcome on the case's inputs (the test checks that it does
against the same inputs at the default), and holds the port to loam_tpu
there.  Feature knobs: extract_features on 3 ingested sweeps of
torch_parity.make_sweeps (seed 3); the labels and the sharp, less-sharp,
flat and full clouds identical, less-flat within 1e-5
(tests/test_torch_frontend.py's cumsum grouping).

Cube knobs (cube_size, grid_width, grid_height, grid_depth,
local_cubes): the synthetic room (|x| <= 12 m, -2 <= y <= 6 m) fits in
the 50 m cube around the start in x and y, and the tiny configuration's
ring caps keep its map within 22 m in z, so these knobs change no
mapping step there.  They are held on the map-store functions they
enter, from loam_tpu's map after frames 0-2 of make_sweeps(seed 7) at a
pose 30 m along each axis from its odometry pose of frame 3 (so that the
map lies in the cube (-1, -1, -1) from the sensor's): the FOV mask of
the neighbour cubes, the window's eviction and the FOV-culled local map,
each identical.

Held otherwise, with the reason (NOT_STAGED): n_scans, system_delay and
gravity.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import cli as JC, frontend as JF, map_store as JM
from loam_tpu import odometry as JO, pipeline as JP
from loam_tpu.ops import features as JFT
from loam_tpu.types import Sweep as JSweep

from loam_tpu_torch import cli as TC, map_store as TM
from loam_tpu_torch.config import LoamConfig
from loam_tpu_torch.ops import features as TFT
from loam_tpu_torch.state import pipeline_state_from_numpy
from loam_tpu_torch.types import Sweep

from test_torch_knobs_map import MAPPING_CASES
from test_torch_knobs_odom import ODOMETRY_CASES
from torch_parity import (assert_same_map, make_sweeps, parity_cfg,
                          to_port_cfg, tree_to_numpy, write_sweep_bag)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the 49 LoamConfig fields the port reads that no other port test varies
KNOBS = (
    "n_scans", "system_delay", "curvature_threshold",
    "max_sharp_per_subregion", "max_less_sharp_per_subregion",
    "max_flat_per_subregion", "n_subregions", "suppress_gap_sq",
    "occlusion_diff_sq", "occlusion_rel_thresh", "parallel_beam_frac",
    "less_flat_leaf", "skip_frame_num", "odom_delta_r_break_deg",
    "odom_delta_t_break_cm", "odom_nn_gate_sq", "ring_window",
    "odom_weight_slope", "odom_weight_start_iter", "weight_keep_threshold",
    "odom_rhs_scale", "odom_degen_eigen_threshold",
    "odom_min_correspondences", "odom_min_corner_last", "odom_min_surf_last",
    "odom_y_scale", "cube_size", "grid_width", "grid_height", "grid_depth",
    "local_cubes", "map_nn_gate_sq", "map_line_eigen_ratio",
    "map_line_halflength", "map_plane_tolerance", "map_weight_slope",
    "map_min_correspondences", "map_delta_r_break_deg",
    "map_delta_t_break_cm", "map_degen_eigen_threshold",
    "map_min_corner_from_map", "map_min_surf_from_map", "map_corner_leaf",
    "map_surf_leaf", "imu_blend", "table_ways", "insert_rounds",
    "voxel_count_cap", "gravity",
)

# knob -> value (the inputs: test_feature_knob's 3 sweeps)
FEATURE_CASES = {
    "curvature_threshold": 0.3,
    "max_sharp_per_subregion": 1,
    # at 10 no subregion of these sweeps (about 85 points) has more
    # than 10 less-sharp candidates
    "max_less_sharp_per_subregion": 3,
    "max_flat_per_subregion": 2,
    "n_subregions": 8,
    "suppress_gap_sq": 0.5,
    "occlusion_diff_sq": 0.5,
    # 0.05 and 0.3 change no label here: the occlusion gaps of these
    # sweeps sit far from 0.1 in relative size
    "occlusion_rel_thresh": 0.01,
    "parallel_beam_frac": 0.002,
    "less_flat_leaf": 0.1,
}

# knob -> value (test_map_store_knob's pose 30 m along each axis)
MAP_STORE_CASES = {
    # 20 and 50 keep all 125 cubes in the FOV there, 10 keeps 120
    "cube_size": 10.0,
    "grid_width": 1,
    "grid_height": 1,
    "grid_depth": 1,
    "local_cubes": 0,
}


# knob -> why no stage-level case holds it
NOT_STAGED = {
    "n_scans": "the VLP-16's ring formula: the frontend maps each "
               "point's elevation to one of 16 rings, so another count "
               "is another sensor, which neither package models; both "
               "read it only as the ring axis's length",
    "system_delay": "the command line's data layer (the sweeps skipped "
                    "before the replay): held by test_system_delay_skips_"
                    "as_loam_tpu",
    "gravity": "read by neither package: imu_from_raw fixes g = 9.81 "
               "(loam_tpu/imu.py:75, loam_tpu_torch/imu.py:77), as "
               "src/scanRegistration.cpp:645-647 does; held by "
               "test_gravity_is_read_nowhere",
}


def _t(a):
    return torch.tensor(np.asarray(a))


def test_every_knob_is_held():
    """The cases here, in test_torch_knobs_odom.py and
    test_torch_knobs_map.py, and NOT_STAGED cover
    the 49 knobs, each once, each a field of both packages' LoamConfig,
    each case away from the default."""
    from loam_tpu.config import LoamConfig as JCfg

    staged = [*FEATURE_CASES, *ODOMETRY_CASES, *MAPPING_CASES,
              *MAP_STORE_CASES]
    assert len(KNOBS) == len(set(KNOBS)) == 49
    assert sorted(staged + list(NOT_STAGED)) == sorted(KNOBS)
    fields = {f.name for f in dataclasses.fields(LoamConfig)}
    assert fields == {f.name for f in dataclasses.fields(JCfg)}
    assert set(KNOBS) <= fields
    default = LoamConfig()
    values = {**FEATURE_CASES, **{k: v[0] for k, v in ODOMETRY_CASES.items()},
              **{k: v[0] for k, v in MAPPING_CASES.items()},
              **MAP_STORE_CASES}
    for name, value in values.items():
        assert value != getattr(default, name), name


# ---- feature knobs


@pytest.fixture(scope="module")
def ingested():
    """Three sweeps ingested by loam_tpu (the feature knobs do not reach
    ingest_sweep)."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(3, seed=3)
    js = jax.vmap(lambda x, m: JF.ingest_sweep(x, m, cfg))(
        jnp.asarray(raw), jnp.asarray(msk))
    tsw = Sweep(_t(js.xyz), _t(js.rel), _t(js.mask))
    return js, tsw, TFT.extract_features(tsw, to_port_cfg(cfg))


def _labels(js, tsw, cfg):
    """Each package's per-ring labels and picked masks."""
    tcfg = to_port_cfg(cfg)
    curv, gap, pre, counts = TFT.selection_inputs(tsw, tcfg)
    W = cfg.ring_width
    port = TFT.select_rings(curv.reshape(-1, W), gap.reshape(-1, W),
                            pre.reshape(-1, W), counts.reshape(-1), tcfg)
    ref = jax.vmap(
        lambda x, c, g, p, n: JFT.select_ring(x, c, g, p, n, cfg)
    )(jnp.asarray(js.xyz).reshape(-1, W, 3),
      *(jnp.asarray(a.numpy()).reshape(-1, W) for a in (curv, gap, pre)),
      jnp.asarray(counts.numpy()).reshape(-1))
    return port, ref


CLOUDS = ("sharp", "less_sharp", "flat", "full", "less_flat")


@pytest.mark.parametrize("knob", list(FEATURE_CASES))
def test_feature_knob(knob, ingested):
    js, tsw, default = ingested
    cfg = parity_cfg(**{knob: FEATURE_CASES[knob]})
    tf = TFT.extract_features(tsw, to_port_cfg(cfg))
    changed = [n for n in CLOUDS for f in ("mask", "xyz")
               if not torch.equal(getattr(getattr(tf, n), f),
                                  getattr(getattr(default, n), f))]
    assert changed, f"{knob}={FEATURE_CASES[knob]} changes no feature here"
    jf = jax.vmap(lambda s: JFT.extract_features(s, cfg))(
        JSweep(js.xyz, js.rel, js.mask))
    for name in CLOUDS:
        a, b = getattr(jf, name), getattr(tf, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask),
                                      err_msg=name)
        tol = 1e-5 if name == "less_flat" else 0
        np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz), rtol=0,
                                   atol=tol, err_msg=name)
        np.testing.assert_allclose(b.rel.numpy(), np.asarray(a.rel), rtol=0,
                                   atol=tol, err_msg=name)
    (lab_t, pick_t), (lab_j, pick_j) = _labels(js, tsw, cfg)
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_array_equal(pick_t.numpy(), np.asarray(pick_j))


# ---- cube knobs


@pytest.fixture(scope="module")
def map_mid_run():
    """loam_tpu's map after frames 0-2 and its odometry pose of frame 3."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(4, seed=7)
    _, st = JP.replay_sweeps(jnp.asarray(raw[:3]), jnp.asarray(msk[:3]), cfg,
                             return_state=True)
    feats = JFT.extract_features(JF.ingest_sweep(
        jnp.asarray(raw[3]), jnp.asarray(msk[3]), cfg), cfg)
    _, odom_out = JO.odometry_step(st.odom, feats, None, cfg)
    return st, np.asarray(odom_out.pose)


def _map_store(table, tobe, cfg, pkg):
    """One package's FOV mask, evicted table and local map of `table`
    around the pose tobe (6,)."""
    if pkg is TM:
        center = TM.center_cube(tobe)
    else:
        center = jnp.floor((tobe[3:] + 25.0) / 50.0).astype(jnp.int32)
    fov = pkg.local_cube_fov(center, tobe, cfg)
    kept = pkg.evict_outside_window(table, center, cfg)
    local = pkg.local_map_points(table, center, fov, cfg.max_surf_from_map,
                                 cfg)
    return fov, kept, local


@pytest.mark.parametrize("knob", list(MAP_STORE_CASES))
def test_map_store_knob(knob, map_mid_run):
    st, pose = map_mid_run
    tobe = pose + np.float32(30.0) * np.array(
        [0, 0, 0, 1, 1, 1], np.float32)
    cfg = parity_cfg(**{knob: MAP_STORE_CASES[knob]})
    table = pipeline_state_from_numpy(tree_to_numpy(st),
                                      device="cpu").map.surf_map
    fov, kept, local = _map_store(table, _t(tobe), to_port_cfg(cfg), TM)
    dfov, dkept, dlocal = _map_store(table, _t(tobe),
                                     to_port_cfg(parity_cfg()), TM)
    assert (fov.shape != dfov.shape or not torch.equal(fov, dfov)
            or int(kept.n_live()) != int(dkept.n_live())
            or int(local.n_local) != int(dlocal.n_local)), \
        f"{knob}={MAP_STORE_CASES[knob]} changes nothing here"
    jfov, jkept, jlocal = _map_store(st.map.surf_map, jnp.asarray(tobe), cfg,
                                     JM)
    np.testing.assert_array_equal(fov.numpy(), np.asarray(jfov))
    assert int(kept.n_live()) == int(jkept.n_live())
    if int(kept.n_live()):
        assert_same_map(jkept, kept)
    assert int(local.n_local) == int(jlocal.n_local)
    assert int(local.sort_axis) == int(jlocal.sort_axis)
    np.testing.assert_array_equal(local.mask.numpy(), np.asarray(jlocal.mask))
    np.testing.assert_array_equal(local.xyz.numpy(), np.asarray(jlocal.xyz))


# ---- the knobs held outside the stages


def test_system_delay_skips_as_loam_tpu(tmp_path):
    """Without --skip the command line drops the first system_delay
    sweeps of a bag: at 1 the port loads loam_tpu's sweeps, stamps and
    IMU stream, one sweep fewer than at 0."""
    raw, msk, _ = make_sweeps(3, n_azimuth=240)
    bag = str(tmp_path / "three.bag")
    stamps = 10.0 + 0.1 * np.arange(3)
    write_sweep_bag(bag, list(zip(raw, msk)), stamps)
    argv = ["--bag", bag, "--ring-width", "512", "--imu-topic", ""]
    loaded = {}
    for delay in (0, 1):
        got = []
        for pkg in (TC, JC):
            args = pkg.build_parser().parse_args(argv)
            cfg = dataclasses.replace(pkg._config(args), system_delay=delay)
            got.append(pkg._load_data(args, cfg))
        for g, w in zip(got[0][:3], got[1][:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        loaded[delay] = got[0]
    assert loaded[0][0].shape[0] == 3 and loaded[1][0].shape[0] == 2
    np.testing.assert_array_equal(loaded[1][2], loaded[0][2][1:])


def test_gravity_is_read_nowhere():
    """No module of either package reads cfg.gravity: both convert the
    IMU with a fixed 9.81 (NOT_STAGED), so no value can change an
    outcome.  A package that starts reading it must gain a case here."""
    for pkg in ("loam_tpu", "loam_tpu_torch"):
        for path in sorted((ROOT / pkg).rglob("*.py")):
            text = path.read_text()
            if path.name == "config.py":
                continue
            assert not re.search(r"\.gravity\b", text), path
    for imu in ("loam_tpu/imu.py", "loam_tpu_torch/imu.py"):
        assert re.search(r"g = (jnp\.float32\()?9\.81",
                         (ROOT / imu).read_text()), imu
