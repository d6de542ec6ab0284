"""yt integration: expose grackle_tpu_torch-derived quantities as yt
fields (port of grackle_tpu/yt_fields.py).

Mirror of grackle: src/python/pygrackle/yt_fields.py:13-206.  Import is
gated on yt being installed (``import yt`` happens only in
``_require_yt``); everything else (parameter translation from Enzo dataset
parameters, fluid-container construction per data chunk, derived-field
registration) follows the reference behavior, on the port's
``FluidContainer``.  The chemistry runs on ``device`` (the CUDA card
unless ``device="cpu"``), with the tables from ``cloudy_data`` when given.
"""

from __future__ import annotations

import numpy as np

from .api import ChemistryData
from .fluid_container import FluidContainer


def _require_yt():
    try:
        import yt  # noqa: F401
        from yt.fields.field_detector import FieldDetector
        return FieldDetector
    except ImportError as exc:  # pragma: no cover
        raise ImportError(
            "yt is required for grackle_tpu_torch.yt_fields; install yt or "
            "use the FluidContainer API directly."
        ) from exc


# grackle parameter -> Enzo dataset parameter
_ENZO_PARAMETER_MAP = {
    "use_grackle": "use_grackle",
    "Gamma": "Gamma",
    "primordial_chemistry": "MultiSpecies",
    "metal_cooling": "MetalCooling",
    "h2_on_dust": "H2FormationOnDust",
    "cmb_temperature_floor": "CMBTemperatureFloor",
    "three_body_rate": "ThreeBodyRate",
    "cie_cooling": "CIECooling",
    "h2_optical_depth_approximation": "H2OpticalDepthApproximation",
    "photoelectric_heating": "PhotoelectricHeating",
    "photoelectric_heating_rate": "PhotoelectricHeatingRate",
    "NumberOfTemperatureBins": "NumberOfTemperatureBins",
    "CaseBRecombination": "CaseBRecombination",
    "TemperatureStart": "TemperatureStart",
    "TemperatureEnd": "TemperatureEnd",
    "NumberOfDustTemperatureBins": "NumberOfDustTemperatureBins",
    "DustTemperatureStart": "DustTemperatureStart",
    "DustTemperatureEnd": "DustTemperatureEnd",
    "HydrogenFractionByMass": "HydrogenFractionByMass",
    "DeuteriumToHydrogenRatio": "DeuteriumToHydrogenRatio",
    "SolarMetalFractionByMass": "SolarMetalFractionByMass",
    "UVbackground_redshift_on": "RadiationRedshiftOn",
    "UVbackground_redshift_off": "RadiationRedshiftOff",
    "UVbackground_redshift_fullon": "RadiationRedshiftFullOn",
    "UVbackground_redshift_drop": "RadiationRedshiftDropOff",
    "use_radiative_transfer": "RadiativeTransfer",
    "radiative_transfer_coupled_rate_solver":
        "RadiativeTransferCoupledRateSolver",
    "radiative_transfer_hydrogen_only": "RadiativeTransferHydrogenOnly",
    "with_radiative_cooling": "with_radiative_cooling",
    "use_volumetric_heating_rate": "use_volumetric_heating_rate",
    "use_specific_heating_rate": "use_specific_heating_rate",
    "self_shielding_method": "self_shielding_method",
    "H2_self_shielding": "H2_self_shielding",
    "grackle_data_file": "grackle_data_file",
    "UVbackground": "UVbackground",
    "Compton_xray_heating": "Compton_xray_heating",
    "LWbackground_intensity": "LWbackground_intensity",
    "LWbackground_sawtooth_suppression":
        "LWbackground_sawtooth_suppression",
}

_FIELD_MAP = {
    "density": (("gas", "density"), "code_mass / code_length**3"),
    "HI": (("gas", "H_p0_density"), "code_mass / code_length**3"),
    "HII": (("gas", "H_p1_density"), "code_mass / code_length**3"),
    "HM": (("gas", "H_m1_density"), "code_mass / code_length**3"),
    "HeI": (("gas", "He_p0_density"), "code_mass / code_length**3"),
    "HeII": (("gas", "He_p1_density"), "code_mass / code_length**3"),
    "HeIII": (("gas", "He_p2_density"), "code_mass / code_length**3"),
    "H2I": (("gas", "H2_p0_density"), "code_mass / code_length**3"),
    "H2II": (("gas", "H2_p1_density"), "code_mass / code_length**3"),
    "DI": (("gas", "D_p0_density"), "code_mass / code_length**3"),
    "DII": (("gas", "D_p1_density"), "code_mass / code_length**3"),
    "HDI": (("gas", "HD_p0_density"), "code_mass / code_length**3"),
    "de": (("gas", "El_density"), "code_mass / code_length**3"),
    "metal": (("gas", "total_metal_density"),
              "code_mass / code_length**3"),
    "dust": (("gas", "dust_density"), "code_mass / code_length**3"),
    "x-velocity": (("gas", "velocity_x"), "code_velocity"),
    "y-velocity": (("gas", "velocity_y"), "code_velocity"),
    "z-velocity": (("gas", "velocity_z"), "code_velocity"),
    "energy": (("gas", "specific_thermal_energy"), "code_velocity**2"),
    "RT_heating_rate": (("gas", "photo_gamma"), "erg/s"),
}

_GRACKLE_FIELDS = {
    "cooling_time": "code_time",
    "dust_temperature": "K",
    "gamma": "",
    "mean_molecular_weight": "",
    "pressure": "code_mass * code_velocity**2 / code_length**3",
    "temperature": "K",
}

_MP_OVER_ME = 1.67262171e-24 / 9.10938215e-28


def _get_needed_fields(my_chemistry):
    fields = ["density", "energy"] + [
        f"{ax}-velocity" for ax in "xyz"
    ]
    if my_chemistry.primordial_chemistry > 0:
        fields += ["HI", "HII", "HeI", "HeII", "HeIII", "de"]
    if my_chemistry.primordial_chemistry > 1:
        fields += ["HM", "H2I", "H2II"]
    if my_chemistry.primordial_chemistry > 2:
        fields += ["DI", "DII", "HDI"]
    if my_chemistry.metal_cooling == 1:
        fields += ["metal"]
    if my_chemistry.use_dust_density_field == 1:
        fields += ["dust"]
    if my_chemistry.use_radiative_transfer == 1:
        fields += ["RT_heating_rate"]
    return fields


def _data_to_fc(data, size=None, fc=None):
    if size is None:
        size = data["gas", "density"].size
    if fc is None:
        fc = FluidContainer(data.ds.grackle_data, size)

    flatten = len(data["gas", "density"].shape) > 1
    fields = _get_needed_fields(fc.chemistry_data)
    for gfield in fields:
        yfield, units = _FIELD_MAP[gfield]
        fdata = data[yfield].to(units)
        if flatten:
            fdata = fdata.flatten()
        fc[gfield][:] = fdata
    if "de" in fc:
        # grackle convention: electron density scaled by mp/me
        fc["de"] *= _MP_OVER_ME
    return fc


def prepare_grackle_data(ds, parameters=None, parameter_map=None,
                         device="cuda", cloudy_data=None):
    """Build a chemistry_data from a yt dataset's parameters and attach it
    as ds.grackle_data (yt_fields.py:118-152); ``device`` and
    ``cloudy_data`` go to ``initialize``."""
    _require_yt()
    if parameter_map is None:
        parameter_map = _ENZO_PARAMETER_MAP

    all_parameters = {
        gpar: ds.parameters[dpar]
        for gpar, dpar in parameter_map.items()
        if dpar in ds.parameters
    }
    all_parameters["use_grackle"] = 1
    if parameters:
        all_parameters.update(parameters)

    my_chemistry = ChemistryData()
    for gpar, val in all_parameters.items():
        if val is None:
            continue
        if isinstance(val, bytes):
            val = val.decode()
        setattr(my_chemistry, gpar, val)

    my_chemistry.comoving_coordinates = ds.cosmological_simulation
    my_chemistry.density_units = (
        ds.mass_unit / ds.length_unit**3
    ).in_cgs().d
    my_chemistry.length_units = ds.length_unit.in_cgs().d
    my_chemistry.time_units = ds.time_unit.in_cgs().d
    my_chemistry.a_units = 1 / (
        1 + ds.parameters.get("CosmologyInitialRedshift", 0)
    )
    my_chemistry.a_value = (
        1 / (1 + ds.current_redshift) / my_chemistry.a_units
    )
    my_chemistry.initialize(device=device, cloudy_data=cloudy_data)
    ds.grackle_data = my_chemistry


def _grackle_field(field, data):
    FieldDetector = _require_yt()
    gfield = field.name[1][len("grackle_"):]
    units = _GRACKLE_FIELDS[gfield]

    if not hasattr(data.ds, "grackle_data"):
        raise RuntimeError("Grackle has not been initialized.")

    fc = _data_to_fc(data)
    if not isinstance(data, FieldDetector):
        func = f"calculate_{gfield}"
        getattr(fc, func)()

    fdata = fc[gfield]
    if hasattr(data, "ActiveDimensions"):
        fdata = fdata.reshape(data.ActiveDimensions)
    return fdata * data.ds.quan(1, units).in_cgs()


def _total_metal_density(field, data):
    field_data = data.ds.arr(
        np.zeros(data["index", "ones"].shape),
        "code_mass / code_length**3",
    )
    for fl in [("enzo", "Metal_Density"), ("enzo", "SN_Colour")]:
        if fl in data.ds.field_list:
            field_data += data[fl]
    return field_data


def add_grackle_fields(ds, parameters=None, device="cuda",
                       cloudy_data=None):
    """Register grackle_* derived fields on a yt dataset
    (yt_fields.py:195-206); ``device`` and ``cloudy_data`` as in
    :func:`prepare_grackle_data`."""
    _require_yt()
    ds.add_field(("gas", "total_metal_density"),
                 function=_total_metal_density,
                 units="g/cm**3",
                 sampling_type="cell")
    prepare_grackle_data(ds, parameters=parameters, device=device,
                         cloudy_data=cloudy_data)
    for field, units in _GRACKLE_FIELDS.items():
        fname = f"grackle_{field}"
        funits = str(ds.quan(1, units).in_cgs().units)
        ds.add_field(("gas", fname), function=_grackle_field,
                     sampling_type="cell", units=funits)
