"""yt integration example (port of examples/yt_grackle.py).

Mirror of grackle: src/python/examples/yt_grackle.py -- load an Enzo
dataset with yt, attach grackle_* derived fields, and sample them.
Requires yt and a dataset path in YT_DATASET; the fields are computed on
GRACKLE_TPU_TORCH_DEVICE (default cuda).

    YT_DATASET=... python -m grackle_tpu_torch.examples.yt_grackle
"""

import os
import sys

from grackle_tpu_torch import add_grackle_fields
from grackle_tpu_torch.examples.common import get_device


def main():
    try:
        import yt
    except ImportError:
        sys.exit("yt is required for this example")

    ds_path = os.environ.get("YT_DATASET")
    if not ds_path:
        sys.exit("set YT_DATASET to an Enzo dataset path")

    ds = yt.load(ds_path)
    add_grackle_fields(ds, device=get_device())
    sp = ds.sphere(ds.domain_center, (10, "kpc"))
    print("cooling time:", sp["gas", "grackle_cooling_time"])
    print("temperature:", sp["gas", "grackle_temperature"])


if __name__ == "__main__":
    main()
