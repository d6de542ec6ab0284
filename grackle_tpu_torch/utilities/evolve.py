"""Evolution loops: free-fall collapse and constant-density cooling
(port of grackle_tpu/utilities/evolve.py).

Mirror of grackle: src/python/pygrackle/utilities/evolve.py:22-183, without
the hard yt dependency (data arrays come back as plain NumPy in CGS; if yt
is installed the caller can wrap them).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .physical_constants import (
    gravitational_constant_cgs,
    sec_per_year,
)


def evolve_freefall(fc, final_density, safety_factor=0.01,
                    include_pressure=True, verbose=True):
    """Modified free-fall collapse per Omukai et al. 2005
    (evolve.py:22-111)."""
    my_chemistry = fc.chemistry_data

    gravitational_constant = (
        4.0 * np.pi * gravitational_constant_cgs
        * my_chemistry.density_units * my_chemistry.time_units**2
    )
    freefall_time_constant = np.power(
        (32.0 * gravitational_constant) / (3.0 * np.pi), 0.5
    )

    data = defaultdict(list)
    current_time = 0.0
    while (fc["density"][0] * my_chemistry.density_units
           < final_density):
        dt = safety_factor * np.power(
            (3.0 * np.pi)
            / (32.0 * gravitational_constant * fc["density"][0]),
            0.5,
        )

        add_to_data(fc, data, current_time)

        if include_pressure:
            force_factor = calculate_collapse_factor(
                data["pressure"], data["density"]
            )
        else:
            force_factor = 0.0
        data["force_factor"].append(force_factor)

        new_density = np.power(
            (np.power(fc["density"][0], -0.5)
             - (0.5 * freefall_time_constant * dt
                * np.power(1 - force_factor, 0.5))),
            -2.0,
        )

        if verbose:
            print(
                "Evolve Freefall - t: %e yr, rho: %e g/cm^3, T: %e K."
                % (current_time * my_chemistry.time_units / sec_per_year,
                   fc["density"][0] * my_chemistry.density_units,
                   fc["temperature"][0])
            )

        density_ratio = new_density / fc["density"][0]
        for field in fc.density_fields:
            fc[field] *= density_ratio

        # adiabatic heating from collapse
        fc["energy"][0] += (
            (my_chemistry.Gamma - 1.0) * fc["energy"][0]
            * freefall_time_constant
            * np.power(fc["density"][0], 0.5) * dt
        )

        fc.solve_chemistry(dt)
        current_time += dt

    return dict(create_data_arrays(fc, data))


def calculate_collapse_factor(pressure, density):
    """Effective adiabatic index -> pressure force factor, Eq. 9 of
    Omukai et al. 2005 (evolve.py:83-111)."""
    if len(pressure) < 3:
        return 0.0

    gamma_eff = np.log10(pressure[-1] / pressure[-2]) / np.log10(
        density[-1] / density[-2]
    )
    if len(pressure) > 2:
        gamma_eff += 0.5 * (
            (np.log10(pressure[-2] / pressure[-3])
             / np.log10(density[-2] / density[-3])) - gamma_eff
        )
    gamma_eff = min(gamma_eff, 4.0 / 3.0)

    if gamma_eff < 0.83:
        force_factor = 0.0
    elif gamma_eff < 1.0:
        force_factor = (0.6 + 2.5 * (gamma_eff - 1)
                        - 6.0 * np.power(gamma_eff - 1.0, 2.0))
    else:
        force_factor = (1.0 + 0.2 * (gamma_eff - 4.0 / 3.0)
                        - 2.9 * np.power(gamma_eff - 4.0 / 3.0, 2.0))
    return min(max(force_factor, 0.0), 0.95)


def evolve_constant_density(fc, final_temperature=None,
                            final_time=None, safety_factor=0.01,
                            verbose=True):
    """(evolve.py:113-143)"""
    my_chemistry = fc.chemistry_data
    if final_temperature is None and final_time is None:
        raise RuntimeError(
            "Must specify either final_temperature or final_time."
        )

    data = defaultdict(list)
    current_time = 0.0
    fc.calculate_cooling_time()
    dt = safety_factor * np.abs(fc["cooling_time"][0])
    fc.calculate_temperature()
    while True:
        if (final_temperature is not None
                and fc["temperature"][0] <= final_temperature):
            break
        if final_time is not None and current_time >= final_time:
            break

        fc.calculate_temperature()
        if verbose:
            print(
                "Evolve constant density - t: %e yr, rho: %e g/cm^3, "
                "T: %e K."
                % (current_time * my_chemistry.time_units / sec_per_year,
                   fc["density"][0] * my_chemistry.density_units,
                   fc["temperature"][0])
            )
        fc.solve_chemistry(dt)

        add_to_data(fc, data, current_time)
        current_time += dt

    return dict(create_data_arrays(fc, data))


def add_to_data(fc, data, current_time=None):
    """Append current container values in CGS (evolve.py:145-163)."""
    for field in fc.density_fields:
        data[field].append(
            fc[field][0] * fc.chemistry_data.density_units
        )
    data["energy"].append(
        fc["energy"][0] * fc.chemistry_data.energy_units
    )
    fc.calculate_temperature()
    data["temperature"].append(fc["temperature"][0])
    fc.calculate_pressure()
    data["pressure"].append(
        fc["pressure"][0] * fc.chemistry_data.pressure_units
    )
    fc.calculate_mean_molecular_weight()
    data["mu"].append(fc["mu"][0])
    if fc.chemistry_data.h2_on_dust:
        fc.calculate_dust_temperature()
        data["dust_temperature"].append(fc["dust_temperature"][0])
    if current_time is not None:
        data["time"].append(
            current_time * fc.chemistry_data.time_units
        )


def create_data_arrays(fc, data):
    """Convert accumulated lists to NumPy arrays (CGS values)."""
    for field in data:
        data[field] = np.array(data[field])
    return data
