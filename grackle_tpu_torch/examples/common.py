"""Shared example helpers (port of examples/common.py): the device and
the grackle data file the examples run with."""

import os

#: the synthetic data file get_data_file writes once, beside the examples
SYNTHETIC_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              ".synthetic_cloudy.h5")


def get_device():
    """``GRACKLE_TPU_TORCH_DEVICE``, default ``cuda``."""
    return os.environ.get("GRACKLE_TPU_TORCH_DEVICE", "cuda")


def get_data_file():
    """``GRACKLE_DATA_FILE`` if it names a file (e.g. a real
    CloudyData_UVB=HM2012.h5), otherwise SYNTHETIC_FILE, written by
    ``data/synthetic.make_synthetic_data_file`` the first time it is
    needed (the schema and values of the JAX package's synthetic file;
    written under a temporary name and renamed, so a process running
    beside this one never reads half of it)."""
    path = os.environ.get("GRACKLE_DATA_FILE")
    if path and os.path.exists(path):
        return path
    if not os.path.exists(SYNTHETIC_FILE):
        from grackle_tpu_torch.data.synthetic import make_synthetic_data_file

        make_synthetic_data_file(SYNTHETIC_FILE)
    return SYNTHETIC_FILE
