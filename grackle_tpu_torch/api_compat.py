"""Deprecated top-level api module shim (port of grackle_tpu/api_compat.py;
mirror of grackle: src/python/pygrackle/api.py)."""

from .api import ChemistryData as chemistry_data  # noqa: F401
from .fluid_container import FluidContainer  # noqa: F401
from .utilities.api import (  # noqa: F401
    evolve_constant_density,
    evolve_freefall,
    set_cosmology_units,
    setup_fluid_container,
)
