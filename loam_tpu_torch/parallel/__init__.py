"""Scenario parallelism (counterpart of loam_tpu/parallel/): the
single-card batched replay.  Sharding over several cards is not
ported yet."""
