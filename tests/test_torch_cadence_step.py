"""The first solving mapping frame at skip_frame_num 0, 2 and 3,
teacher-forced: loam_tpu_torch against loam_tpu run op by op (CPU, plain
kernel versions).

At the C++'s cadence (tests/test_torch_cadence.py) mapping runs at frame
1, on an empty map (an insert, no solve), and first solves at frame 1 +
(skip_frame_num + 1).  That frame runs in each package from loam_tpu's
state: the map of frame 1 and the odometry after frame skip_frame_num +
1, both loam_tpu's.  The port's mapping step must land within
tests/test_torch_mapping.py's tolerances of loam_tpu's mapping_step run
op by op (jax.disable_jit; jitted, XLA fuses the Gauss-Newton body and
rounds differently, ~2e-4 m on such a frame): refined pose within 1e-6
rad / 1e-5 m, maps equal as sets, the same overflow and NaN-skip counts.
The sweeps are tests/test_torch_cadence.py's (make_sweeps seed 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, mapping as JMap, odometry as JO
from loam_tpu import pipeline as JP
from loam_tpu.ops.features import extract_features as j_extract

from loam_tpu_torch import mapping as TMap
from loam_tpu_torch.state import pipeline_state_from_numpy
from loam_tpu_torch.types import PointCloud

from test_torch_cadence import MAX_F, SEED, SKIPS
from test_torch_mapping import _assert_step_matches
from torch_parity import (cloud_to_torch, make_sweeps, parity_cfg,
                          to_port_cfg, tree_to_numpy)

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def odometry_run():
    """loam_tpu's odometry over MAX_F frames (it reads skip_frame_num only
    for its publish flag), and its mapping state after frame 1 (an
    insert into the empty map, run op by op).  Returns (the odometry
    state after each frame, each frame's odometry output, that map
    state)."""
    cfg = parity_cfg()
    raw, msk, _ = make_sweeps(MAX_F, seed=SEED)
    jf = jax.vmap(lambda x, m: j_extract(JF.ingest_sweep(x, m, cfg), cfg))(
        jnp.asarray(raw), jnp.asarray(msk))
    state, states, outs = JO.OdomState.create(cfg), [], []
    for k in range(MAX_F):
        state, out = JO.odometry_step(
            state, jax.tree_util.tree_map(lambda x: x[k], jf), None, cfg)
        states.append(state)
        outs.append(out)
    with jax.disable_jit():
        map1, mout = JMap.mapping_step(
            JMap.MapState.create(cfg), outs[1].pose, outs[1].corner_last,
            outs[1].surf_last, None, cfg)
    assert not bool(mout.solved)
    return states, outs, map1


@pytest.mark.parametrize("skip", SKIPS)
def test_first_solving_mapping_frame_teacher_forced(skip, odometry_run):
    """Frame 1 + (skip + 1) from loam_tpu's state in each package, within
    the mapping tolerances; the solve moved the pose off the prior."""
    states, outs, map1 = odometry_run
    k = skip + 2
    cfg = parity_cfg(skip_frame_num=skip)
    out = outs[k]
    with jax.disable_jit():
        jstate, jout = JMap.mapping_step(map1, out.pose, out.corner_last,
                                         out.surf_last, None, cfg)
    tstate = pipeline_state_from_numpy(tree_to_numpy(
        JP.PipelineState(odom=states[k - 1], map=map1)), device="cpu")
    tnew, tout = TMap.mapping_step(
        tstate.map, _t(out.pose), cloud_to_torch(out.corner_last, PointCloud),
        cloud_to_torch(out.surf_last, PointCloud), to_port_cfg(cfg))
    _assert_step_matches(jstate, jout, tnew, tout)
    assert np.abs(np.asarray(jout.pose_aft) - np.asarray(out.pose)).max() \
        > 1e-4
