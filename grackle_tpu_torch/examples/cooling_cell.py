"""Cooling-cell example: single cell cooling at constant density (port of
examples/cooling_cell.py).

Mirror of grackle: src/python/examples/cooling_cell.py -- tabulated mode
(primordial_chemistry=0), evolve one cell at constant density for
FINAL_TIME Myr (default 100) and save temperature/mu vs time.  The
trajectory is deterministic, so a shorter FINAL_TIME gives a prefix of
the full run.

    python -m grackle_tpu_torch.examples.cooling_cell
"""

import os

import numpy as np

from grackle_tpu_torch import (
    chemistry_data,
    evolve_constant_density,
    setup_fluid_container,
)
from grackle_tpu_torch.examples.common import get_data_file, get_device
from grackle_tpu_torch.utilities.physical_constants import (
    cm_per_mpc,
    mass_hydrogen_cgs,
    sec_per_Myr,
)


def run(final_time=100.0, device=None, cloudy_data=None, verbose=True):
    """The example's computation: {"time", "temperature", "mu"} of one
    cell at 0.1 H/cc cooling from 1e6 K for ``final_time`` Myr."""
    current_redshift = 0.0

    my_chemistry = chemistry_data()
    my_chemistry.use_grackle = 1
    my_chemistry.with_radiative_cooling = 1
    my_chemistry.primordial_chemistry = 0
    my_chemistry.metal_cooling = 1
    my_chemistry.UVbackground = 1

    my_chemistry.comoving_coordinates = 0
    my_chemistry.a_units = 1.0
    my_chemistry.a_value = 1.0 / (1.0 + current_redshift)
    my_chemistry.density_units = mass_hydrogen_cgs
    my_chemistry.length_units = cm_per_mpc
    my_chemistry.time_units = sec_per_Myr
    my_chemistry.set_velocity_units()

    density = 0.1          # g/cm^3 in code units (0.1 H/cc)
    temperature = 1.0e6    # K

    fc = setup_fluid_container(
        my_chemistry,
        density=density * mass_hydrogen_cgs,
        temperature=np.array([temperature]),
        metal_mass_fraction=0.02041,
        converge=False,
        verbose=verbose,
        device=device or get_device(),
        cloudy_data=cloudy_data if cloudy_data is not None
        else get_data_file(),
    )

    data = evolve_constant_density(
        fc, final_time=final_time, safety_factor=0.01, verbose=verbose)
    return {"time": data["time"], "temperature": data["temperature"],
            "mu": data["mu"]}


def main():
    out = run(float(os.environ.get("FINAL_TIME", 100.0)))
    np.savez("cooling_cell.npz", **out)
    print("wrote cooling_cell.npz")


if __name__ == "__main__":
    main()
