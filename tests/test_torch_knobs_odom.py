"""The odometry knobs of LoamConfig, held to loam_tpu (CPU, plain kernel
versions); tests/test_torch_knobs.py holds the feature knobs and checks
that its sibling files cover every knob the port reads.

Each case sets one knob to a value other than its default that changes
the step's outcome on the case's inputs (checked against the same inputs
at the case's base), and runs one odometry_step from loam_tpu's state
after frames 0-2 of torch_parity.make_sweeps(seed 7), carried by
loam_tpu_torch.state, against loam_tpu's run op by op: pose within 1e-6
rad / 1e-5 m, the same publish flag, counter and NaN-skip count, the
corner, surf and full clouds within 1e-5 m.  The convergence gate
odom_delta_r_break_deg binds only once odom_delta_t_break_cm is met;
from the constant-velocity warm start the damped steps (odom_rhs_scale
0.05) of a moving scenario stay above 0.1 cm for tens of iterations, so
that case runs the sensor standing still for 10 iterations, where the
translation step falls under 0.1 cm at the eighth with the rotation
step at 0.012 deg.  The robust weights start at odom_weight_start_iter
= 5, past the tiny configuration's 5 iterations, so the two weight
knobs run 10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import frontend as JF, odometry as JO, pipeline as JP
from loam_tpu.ops import features as JFT

from loam_tpu_torch import odometry as TO
from loam_tpu_torch.state import pipeline_state_from_numpy

from torch_parity import (feats_to_torch, make_sweeps, parity_cfg,
                          pose_errors, to_port_cfg, tree_to_numpy)

torch.set_num_threads(1)

STILL = dict(speed=0.0, yaw_rate=0.0)
# knob -> (value, config changes of the case's base, scenario changes)
ODOMETRY_CASES = {
    # the state's counter is at 1: frame 3 publishes at skip 1, not at 2
    "skip_frame_num": (2, {}, {}),
    "odom_delta_r_break_deg": (1e-3, dict(odom_max_iters=10), STILL),
    "odom_delta_t_break_cm": (10.0, {}, {}),
    "odom_nn_gate_sq": (1.0, {}, {}),
    "ring_window": (1.5, {}, {}),
    "odom_weight_slope": (1.0, dict(odom_max_iters=10), {}),
    "odom_weight_start_iter": (2, {}, {}),
    "weight_keep_threshold": (0.9, dict(odom_max_iters=10), {}),
    "odom_rhs_scale": (0.1, {}, {}),
    "odom_degen_eigen_threshold": (1000.0, {}, {}),
    "odom_min_correspondences": (1000, {}, {}),
    "odom_min_corner_last": (100000, {}, {}),
    "odom_min_surf_last": (100000, {}, {}),
    "odom_y_scale": (1.0, {}, {}),
}


@pytest.fixture(scope="module")
def odom_inputs():
    """scenario changes -> (loam_tpu's state after frames 0-2, its
    features of frame 3), made on first use."""
    cfg = parity_cfg()
    made = {}

    def get(scenario):
        key = tuple(sorted(scenario.items()))
        if key not in made:
            raw, msk, _ = make_sweeps(4, seed=7, **scenario)
            _, st = JP.replay_sweeps(jnp.asarray(raw[:3]),
                                     jnp.asarray(msk[:3]), cfg,
                                     return_state=True)
            feats = JFT.extract_features(
                JF.ingest_sweep(jnp.asarray(raw[3]), jnp.asarray(msk[3]),
                                cfg), cfg)
            made[key] = st, feats
        return made[key]

    return get


@pytest.mark.parametrize("knob", list(ODOMETRY_CASES))
def test_odometry_knob(knob, odom_inputs):
    value, base_over, scenario = ODOMETRY_CASES[knob]
    st, feats = odom_inputs(scenario)
    base = parity_cfg(**base_over)
    cfg = dataclasses.replace(base, **{knob: value})
    tstate = pipeline_state_from_numpy(tree_to_numpy(st), device="cpu")
    tfeats = feats_to_torch(feats)
    tnew, tout = TO.odometry_step(tstate.odom, tfeats, to_port_cfg(cfg))
    _, plain = TO.odometry_step(tstate.odom, tfeats, to_port_cfg(base))
    assert not (torch.equal(tout.pose, plain.pose) and bool(
        tout.publish_to_mapping) == bool(plain.publish_to_mapping)), \
        f"{knob}={value} changes nothing here"
    with jax.disable_jit():
        jnew, jout = JO.odometry_step(st.odom, feats, None, cfg)
    rot, trans = pose_errors(tout.pose.numpy(), jout.pose)
    assert rot < 1e-6 and trans < 1e-5, (rot, trans)
    assert bool(tout.publish_to_mapping) == bool(jout.publish_to_mapping)
    assert int(tnew.frame_count) == int(jnew.frame_count)
    assert int(tnew.nan_skips) == int(jnew.nan_skips)
    for name in ("corner_last", "surf_last", "full"):
        a, b = getattr(jout, name), getattr(tout, name)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz),
                                   rtol=0, atol=1e-5, err_msg=name)
