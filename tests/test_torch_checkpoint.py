"""The port's checkpoints (loam_tpu_torch/checkpoint.py) and stage
tracer (loam_tpu_torch/utils/tracing.py), on the CPU.

A checkpoint is the pipeline state as CPU tensors in one torch.save
file plus a JSON metadata file, committed by renaming its directory
into place: a restored state equals the saved one bit for bit, and a
replay resumed from a checkpoint equals an uninterrupted one bit for
bit.  The tracer's report has loam_tpu.utils.tracing's layout."""

import os

import numpy as np
import pytest
import torch

from loam_tpu.utils import tracing as JT

from loam_tpu_torch import checkpoint as CK, frontend as TF, pipeline as TP
from loam_tpu_torch.ops.features import extract_features
from loam_tpu_torch.types import tree_map
from loam_tpu_torch.utils import tracing as TT

from torch_parity import make_sweeps, parity_cfg, to_port_cfg

torch.set_num_threads(1)

FRAMES = 6


@pytest.fixture(scope="module")
def feats():
    cfg = to_port_cfg(parity_cfg())
    raw, msk, _ = make_sweeps(FRAMES, seed=3)
    return cfg, extract_features(
        TF.ingest_sweep(torch.tensor(raw), torch.tensor(msk), cfg), cfg)


def _leaves(state):
    out = []
    tree_map(out.append, state)
    return out


def _run(cfg, feats, state, frames):
    for k in frames:
        state, out = TP.pipeline_step(state, feats.map(lambda t: t[k]), cfg)
    return state, out


def test_save_restore_is_bit_equal(tmp_path, feats):
    cfg, f = feats
    state, _ = _run(cfg, f, TP.PipelineState.create(cfg, "cpu"), range(4))
    ck = CK.CheckpointManager(str(tmp_path / "ck"))
    ck.save(4, state, metadata={"next_frame": 4})
    assert ck.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ck" / "4")) == ["meta.json",
                                                         "state.pt"]
    fresh = TP.PipelineState.create(cfg, "cpu")
    back, meta = ck.restore(None, fresh)
    assert meta == {"next_frame": 4}
    for a, b in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(state.map.surf_map.n_live()) > 100
    ck.close()


def test_restore_refuses_another_shape(tmp_path, feats):
    cfg, _ = feats
    ck = CK.CheckpointManager(str(tmp_path / "ck"))
    ck.save(1, TP.PipelineState.create(cfg, "cpu"))
    other = TP.PipelineState.create(
        cfg.__class__(**{**vars(cfg), "surf_table_size": 1 << 12}), "cpu")
    with pytest.raises(ValueError, match="surf_map"):
        ck.restore(1, other)
    with pytest.raises(FileNotFoundError):
        CK.CheckpointManager(str(tmp_path / "none")).restore(None, other)


def test_max_to_keep_prunes(tmp_path):
    ck = CK.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in range(1, 6):
        ck.save(step, {"x": torch.full((3,), float(step))})
    assert ck.steps() == [4, 5]
    assert sorted(os.listdir(tmp_path / "ck")) == ["4", "5"]
    # a step saved again replaces its directory whole
    ck.save(5, {"x": torch.zeros(3)}, metadata={"again": True})
    back, meta = ck.restore(5, {"x": torch.ones(3)})
    assert torch.equal(back["x"], torch.zeros(3)) and meta == {"again": True}


def test_failed_save_leaves_no_step(tmp_path):
    """The metadata fails to serialise after the state file is written:
    neither <step> nor the temporary directory is left behind."""
    ck = CK.CheckpointManager(str(tmp_path / "ck"))
    ck.save(2, {"x": torch.ones(3)})
    with pytest.raises(TypeError):
        ck.save(3, {"x": torch.ones(3)}, metadata={"bad": object()})
    assert os.listdir(tmp_path / "ck") == ["2"]
    assert ck.latest_step() == 2


def test_checkpointed_replay_resumes_bit_equal(tmp_path, feats):
    cfg, f = feats

    def step(state, frame):
        return TP.pipeline_step(state, frame, cfg)

    whole, outs_whole = CK.checkpointed_replay(
        step, TP.PipelineState.create(cfg, "cpu"), f,
        CK.CheckpointManager(str(tmp_path / "whole")), every=0)
    assert len(outs_whole) == FRAMES

    ck = CK.CheckpointManager(str(tmp_path / "ck"))
    _, first = CK.checkpointed_replay(
        step, TP.PipelineState.create(cfg, "cpu"),
        f.map(lambda t: t[:4]), ck, every=2)
    assert len(first) == 4 and ck.steps() == [2, 4]
    # a fresh state resumes from the latest checkpoint (frame 4)
    resumed, rest = CK.checkpointed_replay(
        step, TP.PipelineState.create(cfg, "cpu"), f, ck, every=2)
    assert len(rest) == FRAMES - 4
    for out, want in zip(first + rest, outs_whole):
        for name in ("pose_odom", "pose_aft", "pose_integrated", "mapped"):
            assert torch.equal(getattr(out, name), getattr(want, name))
    for a, b in zip(_leaves(resumed), _leaves(whole)):
        assert torch.equal(a, b)
    assert np.abs(whole.odom.transform_sum[3:].numpy()).max() > 0.2


def test_tracer_report_matches_loam_tpu():
    port, ref = TT.Tracer(), JT.Tracer()
    for tracer, stats in ((port, TT.StageStats), (ref, JT.StageStats)):
        for name, times in (("replay", (1.25, 0.5, 2.0)),
                            ("mapping", (0.0123,)),
                            ("a_stage_with_a_long_name", (10.0, 30.5))):
            for dt in times:
                tracer.stats[name].add(dt)
        assert isinstance(tracer.stats["replay"], stats)
    assert port.report() == ref.report()
    assert port.as_dict() == ref.as_dict()
    port.reset()
    assert port.report() == JT.Tracer().report()


def test_tracer_stage_profiler_and_annotate(tmp_path):
    """A stage times its block and waits for its output (nothing to
    wait for on the CPU); the profiler trace and the annotation run."""
    tracer = TT.Tracer()
    with TT.profiler_trace(str(tmp_path / "trace")):
        with tracer.stage("matmul") as h, TT.annotate("matmul"):
            h["out"] = (torch.ones(64, 64) @ torch.ones(64, 64),
                        {"none": None})
    assert tracer.stats["matmul"].count == 1
    assert tracer.stats["matmul"].total_s > 0
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 100
