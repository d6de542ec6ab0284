"""grackle_tpu_torch: the PyTorch + CUDA port of grackle_tpu.

The same chemistry and radiative-cooling solver as the JAX package
``grackle_tpu`` (which stays in the repository as the reference), written
in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.  The module
layout and function names follow grackle_tpu's, so each module has an
obvious counterpart.  This package imports neither jax nor grackle_tpu.

The ported slices cover ``solve_chemistry`` (monolithic and compacted)
for primordial_chemistry 0-3 with dust, metal (new-style Cloudy) cooling,
the CMB floor and the UV background, ``solve_chemistry_grid`` and the
derived fields.  Entry points put their tensors on the CUDA card unless
the caller passes ``device="cpu"``.  Each subcycle's network region runs
as csrc/network_update.cu on CUDA tensors and as the plain twin
ops/network.py on CPU tensors.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    ChemistryConfig, PARAMETER_REGISTRY, default_config, resolve_config,
)
from .units import CodeUnits  # noqa: F401
from .rates.tables import RateTables, build_rate_tables  # noqa: F401
from .api import (  # noqa: F401
    ChemistryData,
    GrackleContext,
    calculate_cooling_time,
    calculate_dust_temperature,
    calculate_gamma,
    calculate_pressure,
    calculate_temperature,
    initialize,
    solve_chemistry,
    solve_chemistry_grid,
    solve_path,
)
from .fluid_container import FluidContainer  # noqa: F401
from .convert import context_from_numpy  # noqa: F401

# pygrackle's class is lowercase
chemistry_data = ChemistryData
