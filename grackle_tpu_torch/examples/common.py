"""Shared example helpers (port of examples/common.py): the device and
the Cloudy tables the examples run with."""

import os


def get_device():
    """``GRACKLE_TPU_TORCH_DEVICE``, default ``cuda``."""
    return os.environ.get("GRACKLE_TPU_TORCH_DEVICE", "cuda")


def get_data_file():
    """The examples' ``cloudy_data``: ``GRACKLE_DATA_FILE`` if it names a
    file (e.g. a real CloudyData_UVB=HM2012.h5), otherwise the synthetic
    tables built in memory (the schema and values of the JAX package's
    synthetic file, with no h5 file written)."""
    path = os.environ.get("GRACKLE_DATA_FILE")
    if path and os.path.exists(path):
        return path
    from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups

    return synthetic_cloudy_groups()
