"""Fluid container: a dict of field arrays + solver methods (port of
grackle_tpu/fluid_container.py).

Rebuild of pygrackle's FluidContainer
(grackle: src/python/pygrackle/fluid_container.py:54-154) with the same
field names and tiered species sets.  Fields are host NumPy arrays; the
solve and the derived fields move them to the context's device and back.
"""

from __future__ import annotations

import numpy as np
import torch

from .utilities.physical_constants import mass_hydrogen_cgs

_base_fluids = ["density", "metal", "dust"]
_nd_fields = [
    "energy",
    "x-velocity", "y-velocity", "z-velocity",
    "temperature", "dust_temperature", "pressure",
    "gamma", "cooling_time", "mu", "nH",
    "mean_molecular_weight",
]

_fluid_names = {}
_fluid_names[0] = _base_fluids
_fluid_names[1] = _fluid_names[0] + [
    "HI", "HII", "HeI", "HeII", "HeIII", "de"
]
_fluid_names[2] = _fluid_names[1] + ["H2I", "H2II", "HM"]
_fluid_names[3] = _fluid_names[2] + ["DI", "DII", "HDI"]

_rad_trans_names = [
    "RT_heating_rate", "RT_HI_ionization_rate",
    "RT_HeI_ionization_rate", "RT_HeII_ionization_rate",
    "RT_H2_dissociation_rate",
]

_extra_fields = {}
_extra_fields[2] = ["H2_self_shielding_length"]
_extra_fields[3] = _extra_fields[2] + []

# names passed through to the solver core
_SOLVER_FIELDS = [
    "density", "energy", "de", "HI", "HII", "HeI", "HeII", "HeIII",
    "HM", "H2I", "H2II", "DI", "DII", "HDI", "metal", "dust",
    "volumetric_heating_rate", "specific_heating_rate",
    "isrf_habing", "H2_self_shielding_length",
    "H2_custom_shielding_factor",
] + _rad_trans_names


class FluidContainer(dict):
    def __init__(self, chemistry_data, n_vals, dtype="float64",
                 itype="int64"):
        super().__init__()
        self.dtype = dtype
        self.chemistry_data = chemistry_data
        self.n_vals = n_vals
        names = (
            _fluid_names[chemistry_data.primordial_chemistry]
            + _extra_fields.get(chemistry_data.primordial_chemistry, [])
            + _nd_fields
        )
        for fluid in names:
            self._setup_fluid(fluid)
        if chemistry_data.use_radiative_transfer:
            for fluid in _rad_trans_names:
                self._setup_fluid(fluid)
        for htype in ["specific", "volumetric"]:
            if getattr(chemistry_data, f"use_{htype}_heating_rate", 0):
                self._setup_fluid(f"{htype}_heating_rate")
        if getattr(chemistry_data, "use_isrf_field", 0):
            self._setup_fluid("isrf_habing")
        if getattr(chemistry_data, "H2_custom_shielding", 0):
            self._setup_fluid("H2_custom_shielding_factor")

    def _setup_fluid(self, fluid_name):
        self[fluid_name] = np.zeros(self.n_vals, self.dtype)

    @property
    def density_fields(self):
        return _fluid_names[self.chemistry_data.primordial_chemistry]

    @property
    def cooling_units(self):
        return self.chemistry_data.cooling_units

    def calculate_hydrogen_number_density(self):
        my_chemistry = self.chemistry_data
        if my_chemistry.primordial_chemistry == 0:
            self["nH"] = (
                my_chemistry.HydrogenFractionByMass * self["density"]
                * my_chemistry.density_units / mass_hydrogen_cgs
            )
            return
        nH = self["HI"] + self["HII"]
        if my_chemistry.primordial_chemistry > 1:
            nH += self["HM"] + self["H2I"] + self["H2II"]
        if my_chemistry.primordial_chemistry > 2:
            nH += self["HDI"] / 2.0
        self["nH"] = nH * my_chemistry.density_units / mass_hydrogen_cgs

    def calculate_mean_molecular_weight(self):
        # (fluid_container.py:101-136)
        if not (self["energy"] == 0).all():
            self.calculate_temperature()
            self.calculate_gamma()
            self["mu"] = self["temperature"] / (
                self["energy"] * (self["gamma"] - 1.0)
                * self.chemistry_data.temperature_units
            )
            self["mean_molecular_weight"] = self["mu"]
            return
        self["mu"] = np.ones(self["energy"].size)
        self["mean_molecular_weight"] = self["mu"]
        if self.chemistry_data.primordial_chemistry == 0:
            return
        for field in self.density_fields:
            if field == "metal":
                continue
            if (self[field] == 0).all():
                return
        nden = self["metal"] / 16.0
        nden += (
            self["HI"] + self["HII"] + self["de"]
            + (self["HeI"] + self["HeII"] + self["HeIII"]) / 4.0
        )
        if self.chemistry_data.primordial_chemistry > 1:
            nden += self["HM"] + (self["H2I"] + self["H2II"]) / 2.0
        self["mu"] = self["density"] / nden
        self["mean_molecular_weight"] = self["mu"]

    def _solver_fields(self):
        f = {}
        for name in _SOLVER_FIELDS:
            if name in self:
                f[name] = self[name]
        return f

    def _to_host(self, val):
        if isinstance(val, torch.Tensor):
            val = val.cpu().numpy()
        # preserve the container dtype regardless of solver precision
        return np.array(val, dtype=self.dtype)

    def solve_chemistry(self, dt):
        new_f, _ = self.chemistry_data.solve_chemistry(
            self._solver_fields(), dt
        )
        for name, val in new_f.items():
            if name in self:
                self[name] = self._to_host(val)

    def _derived(self, name):
        self[name] = self._to_host(getattr(
            self.chemistry_data, f"calculate_{name}")(self._solver_fields()))

    def calculate_cooling_time(self):
        self._derived("cooling_time")

    def calculate_temperature(self):
        self._derived("temperature")

    def calculate_pressure(self):
        self._derived("pressure")

    def calculate_gamma(self):
        self._derived("gamma")

    def calculate_dust_temperature(self):
        self._derived("dust_temperature")
