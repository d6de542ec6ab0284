"""Per-shard and multi-process solves (port of grackle_tpu/parallel/)."""
