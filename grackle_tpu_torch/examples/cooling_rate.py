"""Cooling-rate example: equilibrium cooling rate vs temperature (port of
examples/cooling_rate.py).

Mirror of grackle: src/python/examples/cooling_rate.py -- constant-density
fluid container over a log-T grid, iterated toward equilibrium, cooling
rate saved as cooling_rate.npz (and plotted if matplotlib is available).

Select the network with PRIMORDIAL_CHEM=0..3 (default 3); the device with
GRACKLE_TPU_TORCH_DEVICE (default cuda).

    python -m grackle_tpu_torch.examples.cooling_rate
"""

import os

import numpy as np

from grackle_tpu_torch import chemistry_data, setup_fluid_container
from grackle_tpu_torch.examples.common import get_data_file, get_device
from grackle_tpu_torch.utilities.physical_constants import (
    cm_per_mpc,
    mass_hydrogen_cgs,
    sec_per_Myr,
)


def run(primordial_chemistry=3, device=None, cloudy_data=None,
        verbose=True):
    """The example's computation: {"temperature", "cooling_rate"} over
    101 temperatures from 1e4 to 1e9 K at 1 H/cc."""
    current_redshift = 0.0

    my_chemistry = chemistry_data()
    my_chemistry.use_grackle = 1
    my_chemistry.with_radiative_cooling = 0
    my_chemistry.primordial_chemistry = primordial_chemistry
    my_chemistry.metal_cooling = 1
    my_chemistry.UVbackground = 1
    my_chemistry.use_specific_heating_rate = 1
    my_chemistry.use_volumetric_heating_rate = 1

    my_chemistry.comoving_coordinates = 0
    my_chemistry.a_units = 1.0
    my_chemistry.a_value = 1.0 / (1.0 + current_redshift)
    my_chemistry.density_units = mass_hydrogen_cgs
    my_chemistry.length_units = cm_per_mpc
    my_chemistry.time_units = sec_per_Myr
    my_chemistry.set_velocity_units()

    density = 1.0  # code units, proper
    temperature = np.logspace(4, 9, 101)
    fc = setup_fluid_container(
        my_chemistry,
        density=density * mass_hydrogen_cgs,
        temperature=temperature,
        converge=(my_chemistry.primordial_chemistry > 0),
        tolerance=0.01,
        max_iterations=200,
        verbose=verbose,
        device=device or get_device(),
        cloudy_data=cloudy_data if cloudy_data is not None
        else get_data_file(),
    )

    fc.calculate_temperature()
    fc.calculate_cooling_time()
    fc.calculate_hydrogen_number_density()
    # cooling rate in erg s^-1 cm^3: e / t_cool * rho / n_H^2 (cgs)
    e_cgs = fc["energy"] * my_chemistry.energy_units
    t_cool_cgs = fc["cooling_time"] * my_chemistry.time_units
    rho_cgs = fc["density"] * my_chemistry.density_units
    cooling_rate = e_cgs / t_cool_cgs * rho_cgs / fc["nH"] ** 2
    return {"temperature": fc["temperature"], "cooling_rate": cooling_rate}


def main():
    out = run(int(os.environ.get("PRIMORDIAL_CHEM", 3)))
    name = "cooling_rate"
    np.savez(name + ".npz", **out)
    print(f"wrote {name}.npz")
    try:
        from matplotlib import pyplot
    except ImportError:
        return
    pyplot.loglog(out["temperature"], np.abs(out["cooling_rate"]))
    pyplot.xlabel("T [K]")
    pyplot.ylabel(r"$|\Lambda|/n_{\rm H}^2$ [erg s$^{-1}$ cm$^3$]")
    pyplot.savefig(name + ".png")
    print(f"wrote {name}.png")


if __name__ == "__main__":
    main()
