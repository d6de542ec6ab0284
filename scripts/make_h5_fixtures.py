#!/usr/bin/env python3
"""Write the HDF5 fixtures of tests/data/h5/ with h5py (libhdf5).

The port reads grackle data files with its own reader,
grackle_tpu_torch/data/h5read.py, on machines that have no h5py and no
libhdf5.  These files, written by libhdf5, are what it is held against
there (chip_smoke.py phase 4j) and here (tests/test_torch_h5read.py):

* synthetic_gz.h5: the tables of grackle_tpu.data.synthetic.
  make_synthetic_data_file, copied dataset by dataset with their
  attributes into chunked datasets (h5py's automatic chunk shape, gzip,
  shuffle); scalars stay contiguous;
* old_style_rank4_gz.h5: make_synthetic_old_style_file(rank=4) copied
  the same way, with the file-level ``old_style`` attribute;
* latest_small.h5: a few KB written with ``libver="latest"`` (superblock
  v3, object header v2, link messages): contiguous and compact datasets,
  a scalar fixed-length and a variable-length string, attributes on the
  root, a group and a dataset, and a big-endian float32 array.

It needs the JAX package and h5py:

    python scripts/make_h5_fixtures.py [--out tests/data/h5]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import h5py
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from grackle_tpu.data.synthetic import (  # noqa: E402
    make_synthetic_data_file, make_synthetic_old_style_file)


def copy_chunked(src_path, dst_path):
    """Every group, dataset and attribute of ``src_path`` into
    ``dst_path``, each array chunked with gzip and shuffle."""
    with h5py.File(src_path, "r") as src, h5py.File(dst_path, "w") as dst:
        for key, val in src.attrs.items():
            dst.attrs[key] = val

        def visit(name, obj):
            if isinstance(obj, h5py.Group):
                out = dst.require_group(name)
            elif obj.shape == ():
                out = dst.create_dataset(name, data=obj[()])
            else:
                out = dst.create_dataset(name, data=obj[...], chunks=True,
                                         compression="gzip", shuffle=True)
            for key, val in obj.attrs.items():
                out.attrs[key] = val

        src.visititems(visit)


def write_latest_small(path):
    """Small file in the newest format: the layouts and types a grackle
    data file written by a recent libhdf5 may hold."""
    with h5py.File(path, "w", libver="latest") as f:
        f.attrs["old_style"] = np.int64(1)
        f.attrs["title"] = "h5read fixture"
        f.attrs["grid"] = np.linspace(0.0, 1.0, 5)
        g = f.create_group("Tables")
        g.attrs["Rank"] = np.int32(2)
        d = g.create_dataset("contiguous", data=np.arange(24.0).reshape(4, 6))
        d.attrs["Dimension"] = np.array([4, 6], dtype=np.int64)
        d.attrs["units"] = np.bytes_("erg/s")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        g.create_dataset("compact", data=np.arange(7, dtype="<i4") - 3,
                         dcpl=dcpl)
        g.create_dataset("big_endian",
                         data=np.linspace(-2.0, 2.0, 9).astype(">f4"))
        f.create_dataset("Info", data=np.bytes_("fixed-length info"))
        f.create_dataset("VlenInfo", data="variable-length info",
                         dtype=h5py.string_dtype())


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                      "h5"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        plain = os.path.join(tmp, "synthetic.h5")
        make_synthetic_data_file(plain)
        copy_chunked(plain, os.path.join(args.out, "synthetic_gz.h5"))
        plain = os.path.join(tmp, "old_style_rank4.h5")
        make_synthetic_old_style_file(plain, rank=4)
        copy_chunked(plain, os.path.join(args.out, "old_style_rank4_gz.h5"))
    write_latest_small(os.path.join(args.out, "latest_small.h5"))
    print(f"h5py {h5py.__version__}, libhdf5 {h5py.version.hdf5_version}")
    for name in sorted(os.listdir(args.out)):
        print(name, os.path.getsize(os.path.join(args.out, name)), "bytes")


if __name__ == "__main__":
    main()
