"""Initialization-time observability (port of grackle_tpu/info.py).

Analogue of the reference's verbosity machinery: the ``grackle_verbose``
global (grackle: src/clib/grackle.h:20), ``show_parameters``
(initialize_chemistry_data.c:269-274), and the GRACKLE_INFO file dump
(initialize_chemistry_data.c:203-245).  The parameter list printed and
written is the JAX package's, line for line.
"""

from __future__ import annotations

import sys
import time

from .config import PARAMETER_REGISTRY
from .version import get_grackle_version

grackle_verbose = False


def set_verbose(flag: bool):
    global grackle_verbose
    grackle_verbose = bool(flag)


def show_parameters(cfg, fp=None):
    """Print every registered parameter and its current value."""
    fp = fp or sys.stdout
    for name in PARAMETER_REGISTRY:
        fp.write(f"{name:40s} = {getattr(cfg, name)!r}\n")


def write_info_file(cfg, units, path="GRACKLE_TPU_INFO"):
    """Dump timestamp, version, and all parameters (the GRACKLE_INFO
    analogue)."""
    v = get_grackle_version()
    with open(path, "w") as fp:
        fp.write(time.strftime("%c") + "\n\n")
        fp.write(f"grackle_tpu_torch version: {v.version}\n")
        fp.write(f"branch: {v.branch}\n")
        fp.write(f"revision: {v.revision}\n\n")
        fp.write("== units ==\n")
        for name in ["comoving_coordinates", "density_units",
                     "length_units", "time_units", "a_units", "a_value"]:
            fp.write(f"{name:40s} = {getattr(units, name)!r}\n")
        fp.write("\n== parameters ==\n")
        show_parameters(cfg, fp)
    return path
