"""loam_tpu_torch's scale-out layer across two processes: two ranks over
gloo on loopback (tests/torch_dcn_worker.py), CPU.

The two ranks are started once for the module.  Each loads its own two
of four scenarios and runs, in one world:
  * dp=2 x tp=1: replay_distributed of its block, the poses gathered;
    both ranks must gather the same poses, bit-equal to one process's
    batched_replay of the global batch, and within 1e-4 rad / 1e-3 m of
    loam_tpu's vmapped replay_sweeps per scenario and frame (the
    scenarios that hold that bound over 5 frames, ROADMAP.md section 3);
    the replay itself makes no collective call;
  * dp=1 x tp=2: the first two scenarios through make_sharded_replay,
    the Jacobian rows of every normal-equation sum split over the two
    ranks: bit-equal across the ranks (the all_reduce hands both the
    same sums), within 5e-4 of the unsplit replay (loam_tpu holds its
    tp=2 replay to that, tests/test_parallel.py);
  * dryrun_multichip(2) at the tiny configuration: finite, equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_tpu import pipeline as JP

from loam_tpu_torch.parallel import replay as TR

from torch_dcn_worker import POSES, run_ranks, worker_cfg
from torch_parity import make_sweeps, parity_cfg, pose_errors

torch.set_num_threads(1)

NPROC = 2
FRAMES = 5
# straight scenarios that hold the whole-replay bound against the jitted
# reference (ROADMAP.md section 3): world seed, speed m/s, yaw rate rad/s
SCENARIOS = ((3, 0.9, 0.12), (2, 0.9, 0.12), (6, 0.8, -0.12),
             (9, 0.6, 0.2))
TP_GATE = 5e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts both ranks, and while they run replays the global batch in
    this process (the port's batched_replay and loam_tpu's vmapped
    replay_sweeps).  Returns (ranks' results, port, loam_tpu)."""
    tmp = tmp_path_factory.mktemp("dcn")
    scen = [make_sweeps(FRAMES, seed=s, speed=v, yaw_rate=w)
            for s, v, w in SCENARIOS]
    raw = np.stack([s[0] for s in scen])
    msk = np.stack([s[1] for s in scen])

    def references():
        port_ref = TR.batched_replay(raw, msk, worker_cfg(), device="cpu")
        cfg = parity_cfg()
        jax_ref = jax.jit(jax.vmap(
            lambda x, m: JP.replay_sweeps(x, m, cfg)))(
            jnp.asarray(raw), jnp.asarray(msk))
        return port_ref, jax_ref

    results, (port_ref, jax_ref) = run_ranks(
        str(tmp), dict(raw=raw, msk=msk), "replay", NPROC,
        during=references)
    return results, port_ref, jax_ref


def test_dp_ranks_gather_the_same_poses(ranks):
    (r0, r1), _, _ = ranks
    for r in (r0, r1):
        assert int(r["world"]) == NPROC
        assert tuple(r["dp_mesh"]) == (NPROC, 1)
        assert int(r["dp_frames"]) == len(SCENARIOS) * FRAMES
        assert r["dp_pose_integrated"].shape == (len(SCENARIOS), FRAMES, 6)
    for n in POSES:
        np.testing.assert_array_equal(r0[f"dp_{n}"], r1[f"dp_{n}"])
    # the ranks agree on the slowest rank's seconds, hence on the rate
    assert r0["dp_elapsed"] == r1["dp_elapsed"] > 0
    assert r0["dp_rate"] == r1["dp_rate"] > 0


def test_dp_replay_equals_one_process_batched_replay(ranks):
    (r0, _), port_ref, _ = ranks
    for n in POSES:
        np.testing.assert_array_equal(r0[f"dp_{n}"],
                                      getattr(port_ref, n).numpy())


def test_dp_replay_matches_loam_tpu(ranks):
    (r0, _), _, jax_ref = ranks
    np.testing.assert_array_equal(r0["dp_mapped"],
                                  np.asarray(jax_ref.mapped))
    over = []
    for n in POSES[:3]:
        got, want = r0[f"dp_{n}"], np.asarray(getattr(jax_ref, n))
        for b in range(got.shape[0]):
            for k in range(FRAMES):
                rot, trans = pose_errors(got[b, k], want[b, k])
                if not (rot < 1e-4 and trans < 1e-3):
                    over.append((n, b, k, rot, trans))
    assert not over, over


def test_dp_path_makes_no_collective_call(ranks):
    """The sharded replay of a dp mesh calls nothing of torch.distributed;
    replay_distributed adds the shard's size check (one all_gather) and
    the timing all_reduce."""
    for r in ranks[0]:
        assert int(r["dp_path_calls"]) == 0
        assert int(r["dp_all_gather"]) == 1
        assert int(r["dp_all_reduce"]) == 1


def test_tp_ranks_agree_bit_for_bit(ranks):
    (r0, r1), _, _ = ranks
    assert tuple(r0["tp_mesh"]) == (1, NPROC)
    for n in POSES:
        np.testing.assert_array_equal(r0[f"tp_{n}"], r1[f"tp_{n}"])
    # one all_reduce a normal-equation sum, and nothing else
    assert int(r0["tp_all_reduce"]) >= FRAMES
    assert int(r0["tp_other"]) == 0


def test_tp_replay_is_within_its_bound_of_the_unsplit_replay(ranks):
    (r0, _), port_ref, _ = ranks
    np.testing.assert_array_equal(r0["tp_mapped"],
                                  port_ref.mapped.numpy()[:2])
    for n in POSES[:3]:
        np.testing.assert_allclose(r0[f"tp_{n}"],
                                   getattr(port_ref, n).numpy()[:2],
                                   rtol=0, atol=TP_GATE)


def test_dryrun_multichip_on_two_ranks(ranks):
    (r0, r1), _, _ = ranks
    assert r0["dry_pose"].shape == (1, 1, 6)
    assert np.isfinite(r0["dry_pose"]).all()
    np.testing.assert_array_equal(r0["dry_pose"], r1["dry_pose"])
