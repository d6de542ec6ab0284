"""Code-unit handling (port of grackle_tpu/units.py).

Host-side unit plumbing, all plain Python floats:

* ``CodeUnits`` mirrors the ``code_units`` struct
  (grackle: src/clib/grackle_types.h:83-94).
* derived units follow src/clib/grackle_units.c:24-42 and the comoving
  bookkeeping in src/clib/solve_chemistry.c:145-155 and
  src/clib/initialize_rates.c:224-285.
"""

from __future__ import annotations

import dataclasses

from .constants import kboltz, mh


@dataclasses.dataclass(frozen=True)
class CodeUnits:
    """Unit system: conversion factors from code units to CGS.

    ``a_value`` is the expansion factor in code units (a = a_value*a_units);
    ``a_units = 1`` is required when ``comoving_coordinates == 0``
    (grackle: initialize_chemistry_data.c:122-127).
    """

    comoving_coordinates: int = 0
    density_units: float = 1.0
    length_units: float = 1.0
    time_units: float = 1.0
    a_units: float = 1.0
    a_value: float = 1.0

    def validate(self):
        if self.comoving_coordinates == 0 and self.a_units != 1.0:
            raise ValueError(
                "a_units must be 1.0 if comoving_coordinates is 0."
            )

    # --- primary derived units (grackle_units.c) ---

    @property
    def velocity_units(self) -> float:
        v = self.length_units / self.time_units
        if self.comoving_coordinates == 1:
            v /= self.a_value
        return v

    @property
    def temperature_units(self) -> float:
        return mh * self.velocity_units**2 / kboltz

    # --- comoving-consistent bases (solve_chemistry.c:145-155) ---

    @property
    def co_length_units(self) -> float:
        if self.comoving_coordinates == 1:
            return self.length_units
        return self.length_units * self.a_value * self.a_units

    @property
    def co_density_units(self) -> float:
        if self.comoving_coordinates == 1:
            return self.density_units
        return self.density_units / (self.a_value * self.a_units) ** 3

    # xbase1/dbase1/tbase1 as used throughout the Fortran kernels
    # (solve_rate_cool_g.F:331-336).

    @property
    def tbase1(self) -> float:
        return self.time_units

    @property
    def xbase1(self) -> float:
        return self.co_length_units / (self.a_value * self.a_units)

    @property
    def dbase1(self) -> float:
        return self.co_density_units * (self.a_value * self.a_units) ** 3

    @property
    def coolunit(self) -> float:
        """Cooling-rate unit (solve_rate_cool_g.F:335,
        initialize_rates.c:284-285)."""
        return (self.a_units**5 * self.xbase1**2 * mh**2) / (
            self.tbase1**3 * self.dbase1
        )

    @property
    def dom(self) -> float:
        """Code density -> proper H number density conversion
        (solve_rate_cool_g.F:331)."""
        return self.density_units * self.a_value**3 / mh

    @property
    def redshift(self) -> float:
        return 1.0 / (self.a_value * self.a_units) - 1.0

    # --- rate-table conversion factors (initialize_rates.c:224-285) ---

    @property
    def kunit(self) -> float:
        density_base1 = self.co_density_units * (
            self.a_value * self.a_units
        ) ** 3
        return (self.a_units**3 * mh) / (density_base1 * self.time_units)

    @property
    def kunit_3bdy(self) -> float:
        density_base1 = self.co_density_units * (
            self.a_value * self.a_units
        ) ** 3
        return self.kunit * (self.a_units**3 * mh) / density_base1

    # convenience units matching pygrackle's chemistry_data properties
    # (grackle: src/python/pygrackle/grackle_wrapper.pyx:551-621)

    @property
    def energy_units(self) -> float:
        return self.velocity_units**2

    @property
    def pressure_units(self) -> float:
        return self.density_units * self.energy_units


def set_cosmology_units(
    hubble_constant=0.704,
    omega_matter=0.268,
    omega_lambda=0.732,
    current_redshift=0.0,
    initial_redshift=0.0,
    comoving_box_size=1.0,
) -> CodeUnits:
    """Enzo-convention cosmological units
    (grackle: src/python/pygrackle/utilities/units.py:16-57)."""
    a_units = 1.0 / (1.0 + initial_redshift)
    return CodeUnits(
        comoving_coordinates=1,
        a_units=a_units,
        a_value=1.0 / (1.0 + current_redshift) / a_units,
        density_units=1.8788e-29
        * omega_matter
        * hubble_constant**2
        * (1.0 + current_redshift) ** 3,
        length_units=3.085678e24
        * comoving_box_size
        / hubble_constant
        / (1.0 + current_redshift),
        time_units=2.519445e17
        / omega_matter**0.5
        / hubble_constant
        / (1.0 + initial_redshift) ** 1.5,
    )


def get_velocity_units(my_units) -> float:
    """(grackle: src/clib/grackle_units.c:24-31)"""
    v = my_units.length_units / my_units.time_units
    if my_units.comoving_coordinates == 1:
        v /= my_units.a_value
    return v


def get_temperature_units(my_units) -> float:
    """(grackle: src/clib/grackle_units.c:38-42)"""
    return mh * get_velocity_units(my_units) ** 2 / kboltz
