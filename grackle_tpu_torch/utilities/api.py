"""Deprecated import shims (port of grackle_tpu/utilities/api.py; mirror
of grackle: src/python/pygrackle/utilities/api.py)."""

from .convenience import setup_fluid_container  # noqa: F401
from .evolve import (  # noqa: F401
    evolve_constant_density,
    evolve_freefall,
)
from .units import set_cosmology_units  # noqa: F401
