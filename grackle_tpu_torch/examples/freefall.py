"""Free-fall collapse example (port of examples/freefall.py).

Mirror of grackle: src/python/examples/freefall.py -- one cell collapsing
under the Omukai et al. 2005 pressure-modified free-fall solution with the
9-species H2 network (optionally with metals via METAL_COOLING=1), from
0.1 H/cc to 1e8 H/cc.  The trajectory is deterministic, so a lower final
density gives a prefix of the full run.

    python -m grackle_tpu_torch.examples.freefall
"""

import os

import numpy as np

from grackle_tpu_torch import chemistry_data, evolve_freefall, FluidContainer
from grackle_tpu_torch.examples.common import get_data_file, get_device
from grackle_tpu_torch.utilities.physical_constants import (
    mass_hydrogen_cgs,
    sec_per_Myr,
    cm_per_mpc,
)

#: the collapse stops once the density reaches this (g/cm^3)
FINAL_DENSITY = 1.0e8 * mass_hydrogen_cgs


def run(metal_cooling=0, final_density=FINAL_DENSITY, device=None,
        cloudy_data=None, verbose=True):
    """The example's computation: {"density", "temperature", "H2I",
    "time"} of the collapse up to ``final_density``."""
    my_chemistry = chemistry_data()
    my_chemistry.use_grackle = 1
    my_chemistry.with_radiative_cooling = 1
    my_chemistry.primordial_chemistry = 2
    my_chemistry.metal_cooling = metal_cooling
    my_chemistry.UVbackground = 0
    my_chemistry.three_body_rate = 0
    my_chemistry.cie_cooling = 1
    my_chemistry.h2_optical_depth_approximation = 1
    if metal_cooling and cloudy_data is None:
        cloudy_data = get_data_file()

    my_chemistry.comoving_coordinates = 0
    my_chemistry.a_units = 1.0
    my_chemistry.a_value = 1.0
    my_chemistry.density_units = mass_hydrogen_cgs
    my_chemistry.length_units = cm_per_mpc
    my_chemistry.time_units = sec_per_Myr
    my_chemistry.set_velocity_units()
    my_chemistry.initialize(device=device or get_device(),
                            cloudy_data=cloudy_data)

    # initial conditions: n = 0.1 /cc, T = 50,000 K, ionized
    fc = FluidContainer(my_chemistry, 1)
    fc["density"][:] = 0.1
    fc["HII"][:] = 0.76 * fc["density"]
    fc["HI"][:] = 1e-20
    fc["HeI"][:] = 0.24 * fc["density"]
    fc["HeII"][:] = 1e-20
    fc["HeIII"][:] = 1e-20
    fc["de"][:] = fc["HII"] + fc["HeII"] / 4 + fc["HeIII"] / 2
    fc["HM"][:] = 1e-20
    fc["H2I"][:] = 1e-20
    fc["H2II"][:] = 1e-20
    if metal_cooling:
        fc["metal"][:] = 1.0e-4 * 0.01295 * fc["density"]
    fc.calculate_mean_molecular_weight()
    fc["energy"][:] = (5.0e4 / my_chemistry.temperature_units
                       / fc["mu"] / (my_chemistry.Gamma - 1.0))
    fc.calculate_temperature()

    data = evolve_freefall(fc, final_density, safety_factor=0.05,
                           verbose=verbose)
    return {"density": data["density"], "temperature": data["temperature"],
            "H2I": data["H2I"], "time": data["time"]}


def main():
    out = run(int(os.environ.get("METAL_COOLING", 0)))
    np.savez("freefall.npz", **out)
    print("wrote freefall.npz")


if __name__ == "__main__":
    main()
