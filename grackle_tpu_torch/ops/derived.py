"""Derived-field calculators: pressure, temperature, gamma, dust
temperature, cooling time (port of grackle_tpu/ops/derived.py).

Batched rebuild of the reference's per-field C entry points
(grackle: src/clib/calculate_pressure.c, calculate_temperature.c,
calculate_gamma.c, calculate_dust_temperature.c, calculate_cooling_time.c /
cool_multi_time_g.F) as functions over the flat cell axis.
"""

from __future__ import annotations

import torch

from ..constants import mh, tiny
from . import cloudy_kernel, dust_kernel
from .common import ipow
from .cooling import cool1d_multi
from .lookup import lookup, table_index

MU_METAL = 16.0
MINIMUM_TEMPERATURE = 1.0


def _gamma_h2_inv(x, nH2, number_density):
    """1 / (gamma_H2 - 1) for the H2 rotational/vibrational levels, at
    x = 6100 K / T (calculate_gamma.c:85-100)."""
    ex = torch.exp(torch.clamp(x, max=10.0))
    exm1 = ex - 1.0
    full = 0.5 * (5.0 + 2.0 * (x * x) * ex / (exm1 * exm1))
    return torch.where((nH2 / number_density > 1e-3) & (x < 10.0), full,
                       torch.full_like(x, 0.5 * 5.0))


def _h2_number_densities(f):
    """(number density without H2, nH2) of calculate_pressure.c:62-72."""
    number_density = (
        0.25 * (f["HeI"] + f["HeII"] + f["HeIII"])
        + f["HI"] + f["HII"] + f["HM"] + f["de"]
    )
    return number_density, 0.5 * (f["H2I"] + f["H2II"])


def calculate_pressure(cfg, us, f, imetal: bool):
    """(calculate_pressure.c:31-128)"""
    d, e = f["density"], f["energy"]
    pressure = torch.clamp((cfg.Gamma - 1.0) * d * e, min=tiny)

    if cfg.primordial_chemistry > 1:
        number_density, nH2 = _h2_number_densities(f)
        temp = torch.clamp(us.utem * pressure / (number_density + nH2),
                           min=1.0)
        gamma_inv = 1.0 / (cfg.Gamma - 1.0)
        gammaH2_inv = _gamma_h2_inv(6100.0 / temp, nH2, number_density)
        gamma1 = 1.0 + (nH2 + number_density) / (
            nH2 * gammaH2_inv + number_density * gamma_inv
        )
        pressure = pressure * (gamma1 - 1.0) / (cfg.Gamma - 1.0)
    return pressure


def _tabulated_rhoH(cfg, f, imetal: bool):
    d = f["density"]
    fh = cfg.HydrogenFractionByMass
    return fh * (d - f["metal"]) if imetal else fh * d


def calculate_temperature(cfg, cloudy_prim, us, f, imetal: bool):
    """(calculate_temperature.c:64-148 for the species path;
    calc_temp_cloudy_g.F via tabulated_temperature for tabulated mode)"""
    if cfg.primordial_chemistry == 0:
        d = f["density"]
        metal = f["metal"] if imetal else torch.zeros_like(d)
        rhoH = _tabulated_rhoH(cfg, f, imetal)
        tgas, _ = cloudy_kernel.tabulated_temperature(
            cloudy_prim, d, metal, f["energy"], rhoH, us.dom, us.zr,
            cfg.TemperatureStart, cfg.Gamma, us.utem, imetal,
        )
        return tgas

    pressure = calculate_pressure(cfg, us, f, imetal)
    number_density = (
        0.25 * (f["HeI"] + f["HeII"] + f["HeIII"])
        + f["HI"] + f["HII"] + f["de"]
    )
    if cfg.primordial_chemistry > 1:
        number_density = number_density + (
            f["HM"] + 0.5 * (f["H2I"] + f["H2II"])
        )
    if imetal:
        number_density = number_density + f["metal"] / MU_METAL
    temperature = pressure * us.utem / torch.clamp(number_density, min=tiny)
    return torch.clamp(temperature, min=MINIMUM_TEMPERATURE)


def calculate_gamma(cfg, cloudy_prim, us, f, imetal: bool):
    """(calculate_gamma.c:38-124)"""
    d = f["density"]
    if cfg.primordial_chemistry <= 1:
        return torch.full_like(d, cfg.Gamma)
    temperature = calculate_temperature(cfg, cloudy_prim, us, f, imetal)
    gamma_inv = 1.0 / (cfg.Gamma - 1.0)
    number_density, nH2 = _h2_number_densities(f)
    gammaH2_inv = _gamma_h2_inv(6100.0 / temperature, nH2, number_density)
    return 1.0 + (nH2 + number_density) / (
        nH2 * gammaH2_inv + number_density * gamma_inv
    )


def calculate_dust_temperature(cfg, tables, cloudy_prim, us, f, units,
                               imetal: bool):
    """(calculate_dust_temperature.c:55-141 + calc_tdust_3d_g.F:60-186);
    ``units`` holds the 0-d ``co_density_units`` (common.BodyUnits)."""
    d = f["density"]
    temperature = calculate_temperature(cfg, cloudy_prim, us, f, imetal)

    if cfg.use_isrf_field > 0:
        myisrf = f["isrf_habing"]
    else:
        myisrf = torch.full_like(d, cfg.interstellar_radiation_field)

    if cfg.primordial_chemistry == 0:
        # tabulated mode has no species fields: the H mass fraction of the
        # metal-free density, as the in-solve dust path uses (the
        # reference's standalone calculator reads HI/HII pointers that a
        # tabulated-mode host never allocates, calc_tdust_3d_g.F:138-141)
        nh = _tabulated_rhoH(cfg, f, imetal)
    else:
        nh = f["HI"] + f["HII"]
        if cfg.primordial_chemistry > 1:
            nh = nh + f["H2I"] + f["H2II"]
    # densities are not converted to proper here: urho, not dom
    # (calc_tdust_3d_g.F:143-145)
    nh = nh * units.co_density_units / mh

    ti = table_index(
        torch.log(temperature), cfg.NumberOfTemperatureBins,
        cfg.TemperatureStart, cfg.TemperatureEnd,
    )
    gasgr = lookup(tables.gas_grain, ti)
    gasgr = gasgr * cfg.local_dust_to_gas_ratio * us.coolunit / mh

    trad = 2.73 * (1.0 + us.zr)
    return dust_kernel.dust_temperature(
        temperature, nh, gasgr, tables.gamma_isrf, myisrf, None, trad,
    )


def calculate_cooling_time(
    cfg, tables, cloudy_prim, cloudy_met, pr, us, f,
    imetal: bool, cloudy_data_new: bool = True, comoving: bool = False,
):
    """One cooling-rate pass; cooltime = energy / edot
    (cool_multi_time_g.F:292-299), with densities scaled comoving ->
    proper for the rate evaluation when requested."""
    from .solver import scale_fields

    if comoving:
        f = scale_fields(cfg, dict(f), ipow(us.aye, -3), imetal)
    d = f["density"]
    cool = cool1d_multi(
        cfg, tables, cloudy_prim, cloudy_met, pr, us, f,
        torch.zeros_like(d),
        torch.ones(d.shape, dtype=torch.bool, device=d.device),
        imetal, cloudy_data_new,
    )
    energy = torch.clamp(cool.p2d / (cfg.Gamma - 1.0), min=tiny)
    return energy / cool.edot
