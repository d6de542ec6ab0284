"""The benchmark of grackle_tpu_torch (see README.md)."""
