"""Radiative cooling/heating rate assembly (port of
grackle_tpu/ops/cooling.py).

Batched rebuild of the reference's per-row cooling kernel
(grackle: src/clib/cool1d_multi_g.F:6-1131) as one function over the flat
cell axis: species state in, edot/tgas/tdust/mmw out.  Physics switches
are host-side config flags, so only the enabled processes run.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import tracing
from ..constants import mh, tiny
from . import cloudy_cool, cloudy_kernel, dust_kernel
from .common import dtype_tiny8
from .lookup import TableLookup, table_index

MU_METAL = 16.0  # approx. mean molecular weight of metals


@dataclasses.dataclass(frozen=True)
class CoolResult:
    edot: Any
    tgas: Any
    tgasold: Any
    mmw: Any
    p2d: Any
    tdust: Any
    rhoH: Any
    mynh: Any
    myde: Any
    metallicity: Any
    dust2gas: Any
    ti: Any  # half-step-temperature TableIndex


def _fssh(nratio):
    """Rahmati et al. 2013 self-shielding suppression factor
    (cool1d_multi_g.F:788-792)."""
    return (0.98 * torch.pow(1.0 + torch.pow(nratio, 1.64), -2.28)
            + 0.02 * torch.pow(1.0 + nratio, -0.84))


def _nssh(avgsig, tgas, k_rate, tbase1):
    """Rahmati et al. 2013 self-shielding density threshold
    (cool1d_multi_g.F:783-786); avgsig, k_rate and tbase1 are 0-d
    tensors."""
    return (6.73e-3 * torch.pow(avgsig / 2.49e-18, -2.0 / 3.0)
            * torch.pow(tgas / 1.0e4, 0.17)
            * torch.pow(k_rate / tbase1 / 1.0e-12, 2.0 / 3.0))


def compute_temperature_state(cfg, cloudy_prim, us, f, imetal: bool):
    """Temperature, mmw, pressure, rhoH (cool1d_multi_g.F:208-336).

    Returns (p2d, tgas, mmw, rhoH, myde, metallicity, mynh).
    """
    ispecies = cfg.primordial_chemistry
    d = f["density"]
    e = f["energy"]
    gamma = cfg.Gamma

    p2d = (gamma - 1.0) * d * e

    if ispecies == 0:
        fh = cfg.HydrogenFractionByMass
        metal = f["metal"] if imetal else torch.zeros_like(d)
        rhoH = fh * (d - metal) if imetal else fh * d
        tgas, mmw = cloudy_kernel.tabulated_temperature(
            cloudy_prim, d, metal, e, rhoH, us.dom, us.zr,
            cfg.TemperatureStart, gamma, us.utem, imetal,
        )
        myde = torch.zeros_like(d)  # recomputed from mmw in cool1d_multi
        return (p2d, tgas, mmw, rhoH, myde, _metallicity(cfg, f, imetal),
                rhoH * us.dom)
    nden = (
        (f["HeI"] + f["HeII"] + f["HeIII"]) / 4.0
        + f["HI"] + f["HII"] + f["de"]
    )
    rhoH = f["HI"] + f["HII"]
    myde = f["de"]
    if ispecies > 1:
        nden = nden + f["HM"] + (f["H2I"] + f["H2II"]) / 2.0
        rhoH = rhoH + f["H2I"] + f["H2II"]
    if imetal:
        nden = nden + f["metal"] / MU_METAL
    tgas = torch.clamp(p2d * us.utem / nden, min=cfg.TemperatureStart)
    mmw = d / nden
    if ispecies > 1:
        # gamma correction for H2 (cool1d_multi_g.F:294-318)
        nH2 = 0.5 * (f["H2I"] + f["H2II"])
        nother = (
            (f["HeI"] + f["HeII"] + f["HeIII"]) / 4.0
            + f["HI"] + f["HII"] + f["de"]
        )
        x = 6100.0 / tgas
        ex = torch.exp(torch.clamp(x, max=10.0))
        exm1 = ex - 1.0
        gamma2_full = 0.5 * (5.0 + 2.0 * (x * x) * ex / (exm1 * exm1))
        gamma2 = torch.where(
            nH2 / nother > 1.0e-3,
            torch.where(x > 10.0, torch.full_like(x, 0.5 * 5.0),
                        gamma2_full),
            torch.full_like(x, 2.5),
        )
        gamma2 = 1.0 + (nH2 + nother) / (
            nH2 * gamma2 + nother / (gamma - 1.0)
        )
        tgas = tgas * (gamma2 - 1.0) / (gamma - 1.0)

    return (p2d, tgas, mmw, rhoH, myde, _metallicity(cfg, f, imetal),
            rhoH * us.dom)


def _metallicity(cfg, f, imetal: bool):
    d = f["density"]
    if imetal:
        return f["metal"] / d / cfg.SolarMetalFractionByMass
    return torch.zeros_like(d)


def cool1d_multi(
    cfg,
    tables,
    cloudy_prim,
    cloudy_met,
    pr,
    us,
    f,
    tgasold_in,
    first_iter,
    imetal: bool,
    cloudy_data_new: bool = True,
    tdust_prev=None,
) -> CoolResult:
    """Compute edot and the thermodynamic state for every cell.

    Faithful to cool1d_multi_g.F:166-1131 with the iteration mask replaced
    by full-width vector ops (masked lanes are simply ignored downstream).
    """
    ispecies = cfg.primordial_chemistry
    anydust = (cfg.h2_on_dust > 0) or (cfg.dust_chemistry > 0) or (
        cfg.dust_recombination_cooling > 0
    )
    igammah = cfg.photoelectric_heating
    d = f["density"]
    tiny8 = dtype_tiny8(d.dtype)

    p2d, tgas, mmw, rhoH, myde, metallicity, mynh = (
        compute_temperature_state(cfg, cloudy_prim, us, f, imetal)
    )

    tgasold = torch.where(first_iter, tgas, tgasold_in)

    # half-step log temperature (cool1d_multi_g.F:353-355)
    logtem = torch.log(0.5 * (tgas + tgasold))
    ti = table_index(
        logtem, cfg.NumberOfTemperatureBins,
        cfg.TemperatureStart, cfg.TemperatureEnd,
    )

    lk = TableLookup(tables, ti)

    edot = torch.zeros_like(d)
    dom = us.dom
    dom_inv = 1.0 / dom

    # --- 6-species atomic cooling (cool1d_multi_g.F:380-462) ---
    if ispecies > 0:
        de = f["de"]
        HI, HII = f["HI"], f["HII"]
        HeI, HeII, HeIII = f["HeI"], f["HeII"], f["HeIII"]
        de2 = de * de
        edot = edot + (
            # collisional excitation
            - lk["ceHI"] * HI * de
            - lk["ceHeI"] * HeII * de2 * dom / 4.0
            - lk["ceHeII"] * HeII * de / 4.0
            # collisional ionization
            - lk["ciHI"] * HI * de
            - lk["ciHeI"] * HeI * de / 4.0
            - lk["ciHeII"] * HeII * de / 4.0
            - lk["ciHeIS"] * HeII * de2 * dom / 4.0
            # recombination
            - lk["reHII"] * HII * de
            - lk["reHeII1"] * HeII * de / 4.0
            - lk["reHeII2"] * HeII * de / 4.0
            - lk["reHeIII"] * HeIII * de / 4.0
            # bremsstrahlung
            - lk["brem"] * (HII + HeII / 4.0 + HeIII) * de
        )

    # --- H2 cooling (cool1d_multi_g.F:468-651) ---
    if ispecies > 1:
        HI, HII, H2I = f["HI"], f["HII"], f["H2I"]
        de = f["de"]
        if cfg.h2_optical_depth_approximation == 1:
            # RA04 optical-depth approximation (cool1d_multi_g.F:508-514)
            fudge = torch.clamp(
                torch.pow(0.76 * d * dom / 8.0e9, -0.45), max=1.0
            )
        else:
            fudge = torch.ones_like(d)

        variant = cfg.h2_cooling_variant
        if variant == 0:
            # Glover & Abel 2008 (default; cool1d_multi_g.F:470-526)
            h2lte = lk["H2LTE"]
            galdl = (
                lk["GAHI"] * HI + lk["GAH2"] * H2I / 2.0
                + lk["GAHe"] * f["HeI"] / 4.0
                + lk["GAHp"] * HII + lk["GAel"] * de
            )
            gphdl1 = h2lte / dom
            edot = edot - (
                cfg.ih2co * fudge * H2I * h2lte
                / (1.0 + gphdl1 / galdl) / (2.0 * dom)
            )
        elif variant == 1:
            # Galli & Palla 1999 (cool1d_multi_g.F:534-575)
            gpldl = lk["GP99LowDensityLimit"]
            gphdl = lk["GP99HighDensityLimit"]
            gphdl1 = gphdl / (HI * dom)
            edot = edot - (
                cfg.ih2co * fudge * H2I * gphdl
                / (1.0 + gphdl1 / gpldl) / (2.0 * dom)
            )
        else:
            # Lepp & Shull (cool1d_multi_g.F:579-621)
            hyd01k = lk["hyd01k"]
            h2k01 = lk["h2k01"]
            vibh = lk["vibh"]
            roth = lk["roth"]
            rotl = lk["rotl"]
            qq = (1.2 * torch.pow(HI * dom, 0.77)
                  + torch.pow(H2I * dom / 2.0, 0.77))
            vibl = (HI * hyd01k + H2I / 2.0 * h2k01) * dom * 8.18e-13
            edot = edot - cfg.ih2co * fudge * H2I * (
                vibh / (1.0 + vibh / torch.clamp(vibl, min=tiny))
                + roth / (1.0 + roth / torch.clamp(qq * rotl, min=tiny))
            ) / 2.0 / dom

        # CIE cooling with Ripamonti & Abel 2003 tau attenuation
        # (cool1d_multi_g.F:630-649)
        if cfg.cie_cooling == 1:
            cieco = lk["cieco"]
            tau1 = torch.clamp(
                torch.pow((d / 2.0e16) * dom, 2.8), min=1.0e-5)
            ciefudge = torch.clamp(
                (1.0 - torch.exp(-tau1)) / tau1, max=1.0)
            tau2 = torch.clamp(
                torch.pow((d / 2.0e18) * dom, 8.0), min=1.0e-5)
            ciefudge = ciefudge * torch.clamp(
                (1.0 - torch.exp(-tau2)) / tau2, max=1.0
            )
            edot_cie = ciefudge * (edot - H2I * d * cieco)
            edot = torch.where(d * dom > 1.0e10, edot_cie, edot)

    # --- HD cooling (cool1d_multi_g.F:655-686) ---
    if ispecies > 2:
        above_cmb = tgas > us.comp2
        hdlte = torch.where(above_cmb, lk["HDlte"],
                            torch.full_like(tgas, tiny))
        hdlow = torch.where(above_cmb, lk["HDlow"],
                            torch.full_like(tgas, tiny))
        hdlte1 = hdlte / (f["HI"] * dom)
        hdlow1 = torch.clamp(hdlow, min=tiny)
        edot = edot - f["HDI"] * (
            hdlte / (1.0 + hdlte1 / hdlow1)
        ) / (3.0 * dom)

    # --- dust-to-gas ratio & ISRF (cool1d_multi_g.F:690-722) ---
    dust2gas = torch.zeros_like(d)
    if anydust or (igammah > 0):
        if cfg.use_dust_density_field > 0:
            dust2gas = f["dust"] / d
        else:
            dust2gas = cfg.local_dust_to_gas_ratio * metallicity
    if anydust or (igammah > 1):
        if cfg.use_isrf_field > 0:
            myisrf = f["isrf_habing"]
        else:
            myisrf = torch.full_like(d, cfg.interstellar_radiation_field)
    else:
        myisrf = torch.zeros_like(d)

    # --- gas/grain heat transfer + dust temperature
    #     (cool1d_multi_g.F:726-753) ---
    tdust = torch.zeros_like(d)
    if anydust:
        gasgr = lk["gas_grain"]
        gasgr_tdust = (
            cfg.local_dust_to_gas_ratio * gasgr * us.coolunit / mh
        )
        with tracing.dust_block(d):
            tdust = dust_kernel.dust_temperature(
                tgas, mynh, gasgr_tdust, tables.gamma_isrf, myisrf, None,
                us.comp2, tdust_init=tdust_prev,
            )
        edot = edot - gasgr * (tgas - tdust) * dust2gas * rhoH * rhoH

    # --- photoionization heating (cool1d_multi_g.F:758-913) ---
    if ispecies > 0:
        HI, HII = f["HI"], f["HII"]
        HeI, HeII, HeIII = f["HeI"], f["HeII"], f["HeIII"]
        iradshield = cfg.self_shielding_method
        ipiht = float(cfg.ipiht)
        if iradshield == 0:
            edot = edot + ipiht * (
                pr.piHI * HI + pr.piHeI * HeI * 0.25
                + pr.piHeII * HeII * 0.25
            ) / dom
        else:
            with tracing.shield_block("photo_heating", d):
                # a zero rate (the UVB before its ramp) makes the
                # unselected factor inf or nan: the select discards it, as
                # JAX's does
                nssh_H = _nssh(pr.crsHI, tgas, pr.k24, us.tbase1)
                fSShHI = torch.where(pr.k24 < tiny8, 1.0,
                                     _fssh((HI + HII) * dom / nssh_H))
                nssh_He = _nssh(pr.crsHeI, tgas, pr.k26, us.tbase1)
                fSShHeI = torch.where(
                    pr.k26 < tiny8, 1.0,
                    _fssh(0.25 * (HeI + HeII + HeIII) * dom / nssh_He))
                if iradshield == 1:
                    edot = edot + ipiht * (
                        pr.piHI * HI * fSShHI + pr.piHeI * HeI * 0.25
                        + pr.piHeII * HeII * 0.25
                    ) / dom
                elif iradshield == 2:
                    edot = edot + ipiht * (
                        pr.piHI * HI * fSShHI
                        + pr.piHeI * HeI * 0.25 * fSShHeI
                        + pr.piHeII * HeII * 0.25
                    ) / dom
                elif iradshield == 3:
                    # NOTE (parity): the reference drops the 0.25
                    # mass->number factor on HeI in this branch
                    # (cool1d_multi_g.F:901-904).
                    edot = edot + ipiht * (
                        pr.piHI * HI * fSShHI + pr.piHeI * HeI * fSShHeI
                    ) / dom

    # --- tabulated primordial cooling (cool1d_multi_g.F:917-947) ---
    if ispecies == 0:
        edot = edot + cloudy_kernel.cloudy_cooling(
            cloudy_prim, logtem, rhoH, metallicity, dom, us.zr, us.comp2,
            icmbTfloor=0, iClHeat=cfg.UVbackground, iZscale=0,
        )
        # electron density from mean molecular weight
        # (cool1d_multi_g.F:932-945)
        fh = cfg.HydrogenFractionByMass
        myde = 1.0 - mmw * (3.0 * fh + 1.0) / 4.0
        if imetal:
            myde = myde - mmw * f["metal"] / (d * MU_METAL)
        myde = torch.clamp(d * myde / mmw, min=0.0)

    # --- photoelectric heating (cool1d_multi_g.F:951-1001) ---
    if igammah > 0:
        zero = torch.zeros_like(tgas)
        if igammah == 1:
            gammaha_eff = torch.where(
                tgas > 2.0e4, zero, torch.full_like(tgas, tables.gammah))
        elif igammah == 2:
            gammaha_eff = torch.where(
                tgas > 2.0e4, zero, tables.gammah * 0.05 * myisrf
            )
        else:
            pe_X = myisrf * dom_inv * torch.sqrt(tgas) / myde
            pe_eps = (
                4.9e-2 / (1.0 + torch.pow(pe_X / 1925.0, 0.73))
                + (3.7e-2 * torch.pow(tgas / 1.0e4, 0.7))
                / (1.0 + (pe_X / 5000.0))
            )
            gammaha_eff = tables.gammah * pe_eps * myisrf
        edot = edot + (
            gammaha_eff * rhoH * dom_inv * dust2gas
            / cfg.local_dust_to_gas_ratio
        )

    # --- grain recombination cooling (cool1d_multi_g.F:1005-1023) ---
    if (cfg.dust_chemistry > 0) or (cfg.dust_recombination_cooling > 0):
        regr = lk["regr"]
        grbeta = 0.74 / torch.pow(tgas, 0.068)
        edot = edot - (
            regr * torch.pow(myisrf * dom_inv / myde, grbeta)
            * myde * rhoH * dust2gas / cfg.local_dust_to_gas_ratio
        )

    # --- Compton (cool1d_multi_g.F:1027-1041) ---
    edot = edot - us.comp1 * (tgas - us.comp2) * myde * dom_inv
    edot = edot - pr.comp_xray * (tgas - pr.temp_xray) * myde * dom_inv

    # --- photoheating from radiative transfer (cool1d_multi_g.F:1045-1065)
    if cfg.use_radiative_transfer == 1:
        edot = edot + (
            float(cfg.ipiht) * f["RT_heating_rate"] / us.coolunit
            * f["HI"] / dom
        )

    # --- Cloudy metal cooling (cool1d_multi_g.F:1069-1097) ---
    if cfg.metal_cooling == 1:
        if cloudy_data_new:
            edot = edot + cloudy_kernel.cloudy_cooling(
                cloudy_met, logtem, rhoH, metallicity, dom, us.zr,
                us.comp2, icmbTfloor=cfg.cmb_temperature_floor,
                iClHeat=cfg.UVbackground, iZscale=1,
            )
        else:
            de_for_old = f["de"] if ispecies > 0 else myde
            edot = edot + cloudy_cool.cloudy_cooling_old_tables(
                cloudy_met, de_for_old, d, logtem, rhoH, metallicity,
                dom, us.zr, us.comp2,
                icmbTfloor=cfg.cmb_temperature_floor,
                iClHeat=cfg.UVbackground,
                cl_ele_fra=cfg.cloudy_electron_fraction_factor,
            )

    # --- user heating arrays (cool1d_multi_g.F:1101-1120) ---
    if cfg.use_volumetric_heating_rate == 1:
        edot = edot + f["volumetric_heating_rate"] / us.coolunit / dom**2
    if cfg.use_specific_heating_rate == 1:
        edot = edot + (
            f["specific_heating_rate"] * d * mh / us.coolunit / dom
        )

    return CoolResult(
        edot=edot, tgas=tgas, tgasold=tgas, mmw=mmw, p2d=p2d, tdust=tdust,
        rhoH=rhoH, mynh=mynh, myde=myde, metallicity=metallicity,
        dust2gas=dust2gas, ti=ti,
    )
