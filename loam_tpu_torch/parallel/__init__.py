"""Scenario and row parallelism (counterpart of loam_tpu/parallel/): the
batched replay on one card (replay.batched_replay), the (dp, tp) mesh of
ranks with the sharded replay and step (replay.make_mesh,
make_sharded_replay, make_sharded_step), the row-parallel normal
equations (context.row_sharding), and the multi-process layer over
torch.distributed, one process a rank (distributed.initialize,
replay_distributed, gather_metric, scaling_efficiency)."""
