"""The selection knobs through a whole replay: loam_tpu_torch against
loam_tpu (CPU, plain kernel versions) with corner_scan_k, flat_scan_k and
select_argmax set.  The JAX package runs select_ring cut at the depth, or
select_rings_argmax; the port runs its walk with the depth, or unchanged.
As in tests/test_torch_pipeline.py the cadence must be identical and the
poses within 1e-3 m / 1e-4 rad (the jitted JAX replay fuses each
Gauss-Newton body and rounds differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import pipeline as JP

from loam_tpu_torch import frontend as TF, pipeline as TP
from loam_tpu_torch.ops.features import extract_features

from torch_parity import make_sweeps, parity_cfg, pose_errors, to_port_cfg

torch.set_num_threads(1)
FRAMES = 3


@pytest.mark.parametrize("field,value", [("corner_scan_k", 3),
                                         ("flat_scan_k", 3),
                                         ("select_argmax", True)])
def test_replay_with_selection_knob_matches_loam_tpu(field, value):
    cfg = parity_cfg(**{field: value})
    raw, msk, _ = make_sweeps(FRAMES, seed=3)
    jouts = JP.replay_sweeps(jnp.asarray(raw), jnp.asarray(msk), cfg)
    touts = TP.replay_sweeps(raw, msk, to_port_cfg(cfg), device="cpu")
    np.testing.assert_array_equal(touts.mapped.numpy(),
                                  np.asarray(jouts.mapped))
    for name in ("pose_odom", "pose_aft", "pose_integrated"):
        rot, trans = pose_errors(getattr(touts, name).numpy(),
                                 getattr(jouts, name))
        assert rot < 1e-4 and trans < 1e-3, (name, rot, trans)

    # a depth knob changes the features; select_argmax does not
    sweep = TF.ingest_sweep(torch.tensor(raw[:1]), torch.tensor(msk[:1]),
                            to_port_cfg(cfg))
    knob, plain = (extract_features(sweep, to_port_cfg(c))
                   for c in (cfg, parity_cfg()))
    same = all(torch.equal(getattr(knob, n).mask, getattr(plain, n).mask)
               for n in ("sharp", "less_sharp", "flat"))
    assert same == (field == "select_argmax")
