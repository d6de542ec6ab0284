"""Cosmology unit helper (pygrackle-compatible mutating form; port of
grackle_tpu/utilities/units.py).

Mirror of grackle: src/python/pygrackle/utilities/units.py:16-57 — sets
Enzo-convention comoving units as attributes of a chemistry_data object.
"""

from __future__ import annotations

from ..units import set_cosmology_units as _build_units


def set_cosmology_units(my_units, hubble_constant=0.704,
                        omega_matter=0.268, omega_lambda=0.732,
                        current_redshift=0.0, initial_redshift=0.0,
                        comoving_box_size=1.0):
    """Set Enzo-convention cosmological units on a chemistry_data-like
    object (in-place, as pygrackle does)."""
    cu = _build_units(
        hubble_constant=hubble_constant,
        omega_matter=omega_matter,
        omega_lambda=omega_lambda,
        current_redshift=current_redshift,
        initial_redshift=initial_redshift,
        comoving_box_size=comoving_box_size,
    )
    my_units.comoving_coordinates = cu.comoving_coordinates
    my_units.a_units = cu.a_units
    my_units.a_value = cu.a_value
    my_units.density_units = cu.density_units
    my_units.length_units = cu.length_units
    my_units.time_units = cu.time_units
    return my_units
