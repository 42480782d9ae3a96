"""loam_tpu_torch's scale-out layer (parallel/distributed.py and the mesh
of parallel/replay.py) in one process with no process group (CPU).

One process is the (1, 1) mesh: initialize is a no-op, a mesh of more
ranks than processes is refused, the distributed replay and the sharded
replay and step are the batched replay and pipeline_step bit for bit,
gather_metric is the identity, and a data-parallel replay makes no
torch.distributed call at all.  The weak-scaling harness returns its
keys; no wall-clock gate (two ranks of a busy machine time its cores).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from loam_tpu_torch import pipeline as TP
from loam_tpu_torch.parallel import distributed as D
from loam_tpu_torch.parallel import replay as TR

from test_torch_batch import FRAMES, STRAIGHT
from torch_dcn_worker import count_collectives, worker_cfg
from torch_parity import make_sweeps, parity_cfg, to_port_cfg

torch.set_num_threads(1)

POSES = ("pose_odom", "pose_aft", "pose_integrated", "mapped")


@pytest.fixture(scope="module")
def scenarios():
    """test_torch_batch's three straight scenarios and their batched
    replay."""
    cfg = worker_cfg()
    scen = [make_sweeps(FRAMES, seed=s, speed=v, yaw_rate=w)
            for s, v, w in STRAIGHT]
    raw = np.stack([s[0] for s in scen])
    msk = np.stack([s[1] for s in scen])
    return cfg, raw, msk, TR.batched_replay(raw, msk, cfg, device="cpu")


def _assert_equal(got, want):
    for name in POSES:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_worker_cfg_is_parity_cfg():
    assert worker_cfg() == to_port_cfg(parity_cfg())


def test_initialize_is_a_noop_in_one_process():
    D.initialize()
    D.initialize(num_processes=1)
    D.initialize(coordinator_address="127.0.0.1:1", num_processes=1,
                 process_id=0)
    assert not dist.is_initialized()


def test_global_mesh_is_one_by_one():
    for mesh in (D.global_mesh(device="cpu"), TR.make_mesh(devices="cpu"),
                 TR.make_mesh(1, devices="cpu")):
        assert (mesh.dp, mesh.tp, mesh.rank, mesh.world) == (1, 1, 0, 1)
        assert (mesh.dp_rank, mesh.tp_rank) == (0, 0) and mesh.member
        assert mesh.dp_group is None and mesh.tp_group is None
        assert mesh.device == torch.device("cpu")


@pytest.mark.parametrize("n,tp", [(2, 1), (4, 2), (2, 2)])
def test_make_mesh_refuses_more_ranks_than_processes(n, tp):
    with pytest.raises(ValueError, match="one a rank"):
        TR.make_mesh(n, tp=tp, devices="cpu")


def test_make_mesh_refuses_a_tp_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        TR.make_mesh(1, tp=2, devices="cpu")


def test_replay_distributed_equals_batched_replay(scenarios):
    cfg, raw, msk, batched = scenarios
    res = D.replay_distributed(raw, msk, cfg, device="cpu")
    _assert_equal(res.outs, batched)
    assert res.frames_total == 3 * FRAMES
    assert res.elapsed_s > 0 and res.per_chip_rate > 0
    assert res.per_chip_rate == pytest.approx(3 * FRAMES / res.elapsed_s)


def test_sharded_replay_equals_batched_replay(scenarios):
    cfg, raw, msk, batched = scenarios
    run = TR.make_sharded_replay(TR.make_mesh(devices="cpu"), cfg)
    _assert_equal(run(raw, msk), batched)


def test_dp_replay_makes_no_distributed_call(scenarios):
    """Scenarios never communicate: in one process the whole distributed
    replay, the shard and the gather call nothing of torch.distributed."""
    cfg, raw, msk, _ = scenarios
    with count_collectives() as calls:
        mesh = D.global_mesh(device="cpu")
        D.shard_scenarios_from_local(raw[:1], msk[:1], mesh)
        res = D.replay_distributed(raw[:1], msk[:1], cfg, mesh=mesh,
                                   warmup=False)
        D.gather_metric(res.outs.pose_integrated, mesh)
    assert sum(calls.values()) == 0, calls


def test_make_sharded_step_equals_pipeline_step(scenarios):
    """Two steps of the sharded step from a batched state on the batched
    frontend's frames equal pipeline_step's."""
    cfg, raw, msk, _ = scenarios
    feats = TR.batched_frontend(raw[:, :2], msk[:, :2], cfg, device="cpu")
    step = TR.make_sharded_step(TR.make_mesh(devices="cpu"), cfg)
    mine = TR.batched_initial_state(3, cfg, device="cpu")
    ref = TR.batched_initial_state(3, cfg, device="cpu")
    for k in range(2):
        at = feats.map(lambda t: t[:, k])
        mine, out = step(mine, at)
        ref, want = TP.pipeline_step(ref, at, cfg)
        _assert_equal(out, want)
    assert torch.equal(mine.odom.transform, ref.odom.transform)
    assert torch.equal(mine.map.transform_aft, ref.map.transform_aft)


def test_shard_scenarios_moves_them_to_the_mesh_device(scenarios):
    _, raw, msk, _ = scenarios
    r, m = D.shard_scenarios_from_local(raw, msk,
                                        D.global_mesh(device="cpu"))
    assert r.dtype == torch.float32 and m.dtype == torch.bool
    assert np.array_equal(r.numpy(), raw) and np.array_equal(m.numpy(), msk)


def test_gather_metric_is_the_identity():
    x = torch.arange(12.0).reshape(3, 4)
    got = D.gather_metric(x)
    assert isinstance(got, np.ndarray) and np.array_equal(got, x.numpy())
    assert np.array_equal(D.gather_metric(x.numpy()), x.numpy())


def test_scaling_efficiency_returns_its_keys():
    cfg = worker_cfg()
    rep = D.scaling_efficiency(cfg, b_per_chip=1, frames=2, n_points=1024,
                               dp_sizes=(1,), device="cpu")
    assert set(rep) == {"rates", "efficiency"}
    assert set(rep["rates"]) == {1} and rep["rates"][1] > 0
    assert rep["efficiency"] == 1.0
    rep = D.scaling_efficiency(cfg, b_per_chip=1, frames=1, n_points=512,
                               dp_sizes=(None,), device="cpu")
    assert set(rep["rates"]) == {1}


def test_scale_out_entry_points_default_to_the_card():
    """device None is the CUDA device, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    raw = np.zeros((1, 1, 64, 3), np.float32)
    msk = np.zeros((1, 1, 64), bool)
    for call in (D.global_mesh, TR.make_mesh,
                 lambda: D.replay_distributed(raw, msk, worker_cfg()),
                 lambda: D.initialize("127.0.0.1:1", 2, 0)):
        with pytest.raises(RuntimeError, match="device"):
            call()
