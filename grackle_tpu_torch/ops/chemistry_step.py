"""Chemistry network stepping (port of grackle_tpu/ops/chemistry_step.py).

Batched rebuild of the reference's chemistry inner kernels
(grackle: src/clib/solve_rate_cool_g.F):

* :func:`lookup_cool_rates` — per-cell rate lookups, H2 self-shielding
  (Wolcott-Green & Haiman 2019), Rahmati+13 UVB self-shielding, and the
  density-dependent k13 (F:1079-1737),
* :func:`rate_timestep` — dedot/HIdot sums + H2 formation heating
  (F:1743-1953),
* :func:`step_rate` — one linearly-implicit backward-Euler Gauss-Seidel
  sweep of the species network (F:1961-2413),
* :func:`make_consistent` — species renormalization to enforce elemental
  conservation (F:2419-2534).

:func:`rate_timestep` and :func:`step_rate` are the plain half of the
network region (ops/network.py) that csrc/network_update.cu computes in one
launch; their operation order is the kernel's, so every product and sum
here is written out in the order the kernel evaluates it.  Integer powers
are explicit products (``HI * HI`` for JAX's ``HI**2``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..constants import kboltz, mass_h, tiny
from .common import div_host, dtype_tiny8
from .lookup import TableIndex, TableLookup, h2dust_lookup, table_index

_K_NAMES_6 = ["k1", "k2", "k3", "k4", "k5", "k6", "k57", "k58"]
_K_NAMES_9 = ["k7", "k8", "k9", "k10", "k11", "k12", "k13", "k14", "k15",
              "k16", "k17", "k18", "k19", "k22",
              "n_cr_n", "n_cr_d1", "n_cr_d2"]
_K_NAMES_12 = ["k50", "k51", "k52", "k53", "k54", "k55", "k56"]


def k_names(cfg):
    """The per-cell rates lookup_cool_rates produces for this config."""
    names = list(_K_NAMES_6)
    if cfg.primordial_chemistry > 1:
        names += _K_NAMES_9
    if cfg.primordial_chemistry > 2:
        names += _K_NAMES_12
    return names


#: the shield rates carried as [N] arrays (k27 stays a host float)
SHIELD_ARRAYS = ["k24", "k25", "k26", "k28", "k29", "k30", "k31"]


@dataclasses.dataclass(frozen=True)
class RateState:
    """Per-cell interpolated rates.

    k: dict name -> [N] tensor; shields: dict of k24..k31 ([N] tensors,
    except k27, the unshielded host float).
    """

    k: Any
    k13dd: Any
    h2dust: Any
    shields: Any
    ti: TableIndex


def _wg2019_shield(N_H2, tgas, ngas):
    """H2 self-shielding factor, Wolcott-Green & Haiman 2019
    (solve_rate_cool_g.F:1451-1475)."""
    tgas_touse = torch.clamp(tgas, 1.0e2, 8.0e3)
    ngas_touse = torch.clamp(ngas, max=1.0e7)
    awg = (
        (0.8711 * torch.log10(tgas_touse) - 1.928)
        * torch.exp(-0.2856 * torch.log10(ngas_touse))
        + (-0.9639 * torch.log10(tgas_touse) + 3.892)
    )
    x = 2.0e-15 * N_H2
    b_doppler = 1.0e-5 * torch.sqrt(2.0 * kboltz * tgas / mass_h)
    f_shield = (
        0.965 / torch.pow(1.0 + x / b_doppler, awg)
        + 0.035 * torch.exp(-8.5e-4 * torch.sqrt(1.0 + x))
        / torch.sqrt(1.0 + x)
    )
    return torch.clamp(f_shield, max=1.0)


def _rahmati_fshield(avgsig, k_rate, tgas, nloc, tbase1):
    """Rahmati et al. 2013 Eq. 13/14 shield factor
    (solve_rate_cool_g.F:1496-1534); avgsig, k_rate, tbase1 host floats."""
    from .cooling import _spow

    nssh = (
        6.73e-3 * _spow(avgsig / 2.49e-18, -2.0 / 3.0)
        * torch.pow(tgas / 1.0e4, 0.17)
        * _spow(k_rate / tbase1 / 1.0e-12, 2.0 / 3.0)
    )
    nratio = nloc / nssh
    return (0.98 * torch.pow(1.0 + torch.pow(nratio, 1.64), -2.28)
            + 0.02 * torch.pow(1.0 + nratio, -0.84))


def lookup_cool_rates(
    cfg, tables, pr, us, f, tgas, mmw, tdust, dust2gas,
    l_h2shield_field=None,
    imetal: bool = True,
) -> RateState:
    """Interpolate all chemistry rates at the (full-step) gas temperature
    and apply the shielding modifications (solve_rate_cool_g.F:1079-1737).
    """
    ispecies = cfg.primordial_chemistry
    anydust = (cfg.h2_on_dust > 0) or (cfg.dust_chemistry > 0)
    tiny8 = dtype_tiny8(tgas.dtype)
    logtem = torch.log(tgas)
    ti = table_index(
        logtem, cfg.NumberOfTemperatureBins,
        cfg.TemperatureStart, cfg.TemperatureEnd,
    )
    lk = TableLookup(tables, ti)
    k = {name: lk[name] for name in k_names(cfg)}

    k13dd = None
    if ispecies > 1 and cfg.three_body_rate == 0:
        # (N, 14): coefficient lerp at shared indices; only evaluated for
        # the density-dependent k13 path (three_body_rate == 0)
        k13dd = lk.k13dd_matrix()

    h2dust = None
    if anydust:
        # 2-D (T, T_dust) bilinear (solve_rate_cool_g.F:1327-1378)
        d_ti = table_index(
            torch.log(tdust), cfg.NumberOfDustTemperatureBins,
            cfg.DustTemperatureStart, cfg.DustTemperatureEnd,
        )
        h2dust = h2dust_lookup(tables.h2dust, ti, d_ti)
        h2dust = h2dust * dust2gas
        # dust melts above the table end (solve_rate_cool_g.F:1337-1340)
        h2dust = torch.where(tdust > cfg.DustTemperatureEnd,
                             torch.full_like(h2dust, tiny8), h2dust)

    # --- radiation shields (solve_rate_cool_g.F:1382-1676) ---
    d = f["density"]
    shields = {
        "k24": torch.full_like(d, pr.k24),
        "k25": torch.full_like(d, pr.k25),
        "k26": torch.full_like(d, pr.k26),
        "k27": pr.k27,  # unshielded scalar (solve_rate_cool_g.F:2286)
        "k28": torch.full_like(d, pr.k28),
        "k29": torch.full_like(d, pr.k29),
        "k30": torch.full_like(d, pr.k30),
    }

    if ispecies > 1:
        if cfg.use_radiative_transfer == 1:
            k31shield = pr.k31 + f["RT_H2_dissociation_rate"]
        else:
            k31shield = torch.full_like(d, pr.k31)

        if cfg.H2_self_shielding > 0:
            if cfg.H2_self_shielding == 1:
                # Sobolev-like length from the precomputed density-stencil
                # field (solve_rate_cool_g.F:1418-1434)
                l_h2 = l_h2shield_field
            elif cfg.H2_self_shielding == 2:
                l_h2 = f["H2_self_shielding_length"] * us.xbase1
            elif cfg.H2_self_shielding == 3:
                l_h2 = us.c_ljeans * torch.sqrt(tgas / (d * mmw))
            else:
                l_h2 = torch.zeros_like(d)
            N_H2 = us.dom * f["H2I"] * l_h2
            ngas = d * us.dom / mmw
            f_shield = _wg2019_shield(N_H2, tgas, ngas)
            k31shield = f_shield * k31shield

        if cfg.H2_custom_shielding > 0:
            k31shield = f["H2_custom_shielding_factor"] * k31shield
        shields["k31"] = k31shield
    else:
        shields["k31"] = torch.full_like(d, pr.k31)

    iradshield = cfg.self_shielding_method
    if iradshield > 0:
        nH = f["HI"] + f["HII"]
        if ispecies > 1:
            nH = nH + f["HM"] + f["H2I"] + f["H2II"]
            if ispecies > 2:
                nH = nH + 0.5 * (f["DI"] + f["DII"]) \
                    + 2.0 * f["HDI"] / 3.0
        f_shield_H = _rahmati_fshield(
            pr.crsHI, pr.k24, tgas, nH * us.dom, us.tbase1
        )
        nHe = 0.25 * (f["HeI"] + f["HeII"] + f["HeIII"])
        f_shield_He = _rahmati_fshield(
            pr.crsHeI, pr.k26, tgas, nHe * us.dom, us.tbase1
        )

        def shielded(rate, factor):
            return torch.where(rate < tiny8, torch.zeros_like(rate),
                               rate * factor)

        if iradshield >= 1:
            # shield HI (solve_rate_cool_g.F:1540-1568)
            shields["k24"] = shielded(shields["k24"], f_shield_H)
            shields["k29"] = shielded(shields["k29"], f_shield_H)
        if iradshield >= 2:
            # + HeI, H2+ rates follow He (solve_rate_cool_g.F:1570-1624)
            shields["k26"] = shielded(shields["k26"], f_shield_He)
            shields["k28"] = shielded(shields["k28"], f_shield_He)
            shields["k30"] = shielded(shields["k30"], f_shield_He)
        if iradshield == 3:
            # HeII rate zeroed entirely (solve_rate_cool_g.F:1626-1676)
            shields["k25"] = torch.zeros_like(d)

    # --- density-dependent k13 (solve_rate_cool_g.F:1707-1734) ---
    if ispecies > 1 and cfg.three_body_rate == 0:
        nh = torch.clamp(f["HI"] * us.dom, max=1.0e9)
        c = k13dd
        k13_CID = (
            c[:, 0] - c[:, 1] / (1.0 + torch.pow(nh / c[:, 4], c[:, 6]))
            + c[:, 2] - c[:, 3] / (1.0 + torch.pow(nh / c[:, 5], c[:, 6]))
        )
        k13_CID = torch.clamp(torch.pow(10.0, k13_CID), min=tiny8)
        k13_DT = (
            c[:, 7] - c[:, 8] / (1.0 + torch.pow(nh / c[:, 11], c[:, 13]))
            + c[:, 9] - c[:, 10] / (1.0 + torch.pow(nh / c[:, 12],
                                                    c[:, 13]))
        )
        k13_DT = torch.clamp(torch.pow(10.0, k13_DT), min=tiny8)
        k["k13"] = torch.where(
            (tgas >= 500.0) & (tgas < 1.0e6),
            k13_DT + k13_CID,
            torch.full_like(tgas, tiny8),
        )

    return RateState(k=k, k13dd=k13dd, h2dust=h2dust, shields=shields,
                     ti=ti)


def rate_timestep(cfg, rs: RateState, f, us, edot, rhoH):
    """Electron and HI rates of change + H2 formation heating
    (solve_rate_cool_g.F:1743-1953).

    Returns (dedot, HIdot, edot_updated).
    """
    ispecies = cfg.primordial_chemistry
    anydust = (cfg.h2_on_dust > 0) or (cfg.dust_chemistry > 0)
    k = rs.k
    s = rs.shields
    de, HI, HII = f["de"], f["HI"], f["HII"]
    HeI, HeII, HeIII = f["HeI"], f["HeII"], f["HeIII"]

    if ispecies == 1:
        dedot = (
            k["k1"] * HI * de
            + k["k3"] * HeI * de / 4.0
            + k["k5"] * HeII * de / 4.0
            - k["k2"] * HII * de
            - k["k4"] * HeII * de / 4.0
            - k["k6"] * HeIII * de / 4.0
            + k["k57"] * HI * HI
            + k["k58"] * HI * HeI / 4.0
            + (s["k24"] * HI + s["k25"] * HeII / 4.0
               + s["k26"] * HeI / 4.0)
        )
        HIdot = (
            -k["k1"] * HI * de
            + k["k2"] * HII * de
            - k["k57"] * HI * HI
            - k["k58"] * HI * HeI / 4.0
            - s["k24"] * HI
        )
    else:
        HM, H2I, H2II = f["HM"], f["H2I"], f["H2II"]
        HIdot = (
            - k["k1"] * de * HI
            - k["k7"] * de * HI
            - k["k8"] * HM * HI
            - k["k9"] * HII * HI
            - k["k10"] * H2II * HI / 2.0
            - 2.0 * k["k22"] * (HI * HI) * HI
            + k["k2"] * HII * de
            + 2.0 * k["k13"] * HI * H2I / 2.0
            + k["k11"] * HII * H2I / 2.0
            + 2.0 * k["k12"] * de * H2I / 2.0
            + k["k14"] * HM * de
            + k["k15"] * HM * HI
            + 2.0 * k["k16"] * HM * HII
            + 2.0 * k["k18"] * H2II * de / 2.0
            + k["k19"] * H2II * HM / 2.0
            - k["k57"] * HI * HI
            - k["k58"] * HI * HeI / 4.0
            - s["k24"] * HI
            + 2.0 * s["k31"] * H2I / 2.0
        )
        if anydust:
            HIdot = HIdot - 2.0 * rs.h2dust * rhoH
        dedot = (
            k["k1"] * HI * de
            + k["k3"] * HeI * de / 4.0
            + k["k5"] * HeII * de / 4.0
            + k["k8"] * HM * HI
            + k["k15"] * HM * HI
            + k["k17"] * HM * HII
            + k["k14"] * HM * de
            - k["k2"] * HII * de
            - k["k4"] * HeII * de / 4.0
            - k["k6"] * HeIII * de / 4.0
            - k["k7"] * HI * de
            - k["k18"] * H2II * de / 2.0
            + k["k57"] * HI * HI
            + k["k58"] * HI * HeI / 4.0
            + (s["k24"] * HI + s["k25"] * HeII / 4.0
               + s["k26"] * HeI / 4.0)
        )

        # H2 formation heating, Omukai 2000 Eq. 23
        # (solve_rate_cool_g.F:1888-1919); JAX's ``(...) ** -1.0``
        h2heatfac = 1.0 / (
            1.0 + k["n_cr_n"] / (
                us.dom * (HI * k["n_cr_d1"]
                          + H2I * 0.5 * k["n_cr_d2"])
            )
        )
        H2delta = HI * (
            4.48 * k["k22"] * (HI * HI)
            - 4.48 * k["k13"] * H2I / 2.0
        )
        H2delta = torch.where(H2delta > 0.0, H2delta * h2heatfac, H2delta)
        if anydust:
            H2delta = H2delta + (
                rs.h2dust * HI * rhoH * (0.2 + 4.2 * h2heatfac)
            )
        edot = edot + us.chunit * H2delta

    if cfg.use_radiative_transfer == 1:
        kphHI = f["RT_HI_ionization_rate"]
        HIdot = HIdot - kphHI * HI
        if cfg.radiative_transfer_hydrogen_only == 0:
            dedot = dedot + (
                kphHI * HI
                + f["RT_HeI_ionization_rate"] * HeI / 4.0
                + f["RT_HeII_ionization_rate"] * HeII / 4.0
            )
        else:
            dedot = dedot + kphHI * HI

    return dedot, HIdot, edot


def step_rate(cfg, rs: RateState, f, us, dtit, rhoH):
    """One linearly-implicit BE Gauss-Seidel sweep
    (solve_rate_cool_g.F:1961-2413).

    Returns (new_fields, dedot_prev, HIdot_prev): the updated species dict
    and the realized rates-of-change used by the dt limiter's
    high-iteration damping.
    """
    ispecies = cfg.primordial_chemistry
    anydust = (cfg.h2_on_dust > 0) or (cfg.dust_chemistry > 0)
    irt = cfg.use_radiative_transfer == 1
    rt_all = irt and (cfg.radiative_transfer_hydrogen_only == 0)
    tiny8 = dtype_tiny8(f["density"].dtype)
    k = rs.k
    s = rs.shields
    de, HI, HII = f["de"], f["HI"], f["HII"]
    HeI, HeII, HeIII = f["HeI"], f["HeII"], f["HeIII"]
    kphHI = f.get("RT_HI_ionization_rate")
    kphHeI = f.get("RT_HeI_ionization_rate")
    kphHeII = f.get("RT_HeII_ionization_rate")

    if ispecies == 1:
        # --- (A) 6-species H integrator (solve_rate_cool_g.F:2028-2111)
        scoef = k["k2"] * HII * de
        acoef = (k["k1"] * de + k["k57"] * HI
                 + k["k58"] * HeI / 4.0 + s["k24"])
        if irt:
            acoef = acoef + kphHI
        HIp = (scoef * dtit + HI) / (1.0 + acoef * dtit)

        scoef = (k["k1"] * HIp * de + k["k57"] * HIp * HIp
                 + k["k58"] * HIp * HeI / 4.0 + s["k24"] * HIp)
        if irt:
            scoef = scoef + kphHI * HIp
        acoef = k["k2"] * de
        HIIp = (scoef * dtit + HII) / (1.0 + acoef * dtit)

        scoef = (k["k57"] * HIp * HIp + k["k58"] * HIp * HeI / 4.0
                 + s["k24"] * HI + s["k25"] * HeII / 4.0
                 + s["k26"] * HeI / 4.0)
        if rt_all:
            scoef = scoef + (kphHI * HI + kphHeI * HeI / 4.0
                             + kphHeII * HeII / 4.0)
        elif irt:
            scoef = scoef + kphHI * HI
        acoef = -(
            k["k1"] * HI - k["k2"] * HII
            + k["k3"] * HeI / 4.0 - k["k6"] * HeIII / 4.0
            + k["k5"] * HeII / 4.0 - k["k4"] * HeII / 4.0
        )
        dep = (scoef * dtit + de) / (1.0 + acoef * dtit)

    # --- (B) helium chemistry, all ispecies (solve_rate_cool_g.F:2115-2159)
    scoef = k["k4"] * HeII * de
    acoef = k["k3"] * de + s["k26"]
    if rt_all:
        acoef = acoef + kphHeI
    HeIp = (scoef * dtit + HeI) / (1.0 + acoef * dtit)

    scoef = (k["k3"] * HeIp * de + k["k6"] * HeIII * de
             + s["k26"] * HeIp)
    if rt_all:
        scoef = scoef + kphHeI * HeIp
    acoef = k["k4"] * de + k["k5"] * de + s["k25"]
    if rt_all:
        acoef = acoef + kphHeII
    HeIIp = (scoef * dtit + HeII) / (1.0 + acoef * dtit)

    scoef = k["k5"] * HeIIp * de + s["k25"] * HeIIp
    if rt_all:
        scoef = scoef + kphHeII * HeIIp
    acoef = k["k6"] * de
    HeIIIp = (scoef * dtit + HeIII) / (1.0 + acoef * dtit)

    # --- (C) 9-species molecular network (solve_rate_cool_g.F:2163-2306)
    if ispecies > 1:
        HM, H2I, H2II = f["HM"], f["H2I"], f["H2II"]
        scoef = (
            k["k2"] * HII * de
            + 2.0 * k["k13"] * HI * H2I / 2.0
            + k["k11"] * HII * H2I / 2.0
            + 2.0 * k["k12"] * de * H2I / 2.0
            + k["k14"] * HM * de
            + k["k15"] * HM * HI
            + 2.0 * k["k16"] * HM * HII
            + 2.0 * k["k18"] * H2II * de / 2.0
            + k["k19"] * H2II * HM / 2.0
            + 2.0 * s["k31"] * H2I / 2.0
        )
        acoef = (
            k["k1"] * de + k["k7"] * de + k["k8"] * HM
            + k["k9"] * HII + k["k10"] * H2II / 2.0
            + 2.0 * k["k22"] * (HI * HI)
            + k["k57"] * HI + k["k58"] * HeI / 4.0
            + s["k24"]
        )
        if irt:
            acoef = acoef + kphHI
        if anydust:
            acoef = acoef + 2.0 * rs.h2dust * rhoH
        HIp = (scoef * dtit + HI) / (1.0 + acoef * dtit)

        scoef = (
            k["k1"] * HI * de
            + k["k10"] * H2II * HI / 2.0
            + k["k57"] * HI * HI
            + k["k58"] * HI * HeI / 4.0
            + s["k24"] * HI
        )
        if irt:
            scoef = scoef + kphHI * HI
        acoef = (
            k["k2"] * de + k["k9"] * HI + k["k11"] * H2I / 2.0
            + k["k16"] * HM + k["k17"] * HM
        )
        HIIp = (scoef * dtit + HII) / (1.0 + acoef * dtit)

        scoef = (
            k["k8"] * HM * HI + k["k15"] * HM * HI
            + k["k17"] * HM * HII
            + k["k57"] * HI * HI + k["k58"] * HI * HeI / 4.0
            + s["k24"] * HIp + s["k25"] * HeIIp / 4.0
            + s["k26"] * HeIp / 4.0
        )
        if rt_all:
            scoef = scoef + (kphHI * HIp + kphHeI * HeIp / 4.0
                             + kphHeII * HeIIp / 4.0)
        elif irt:
            scoef = scoef + kphHI * HIp
        acoef = -(
            k["k1"] * HI - k["k2"] * HII
            + k["k3"] * HeI / 4.0 - k["k6"] * HeIII / 4.0
            + k["k5"] * HeII / 4.0 - k["k4"] * HeII / 4.0
            + k["k14"] * HM
            - k["k7"] * HI
            - k["k18"] * H2II / 2.0
        )
        dep = (scoef * dtit + de) / (1.0 + acoef * dtit)

        # 7) H2
        scoef = 2.0 * (
            k["k8"] * HM * HI
            + k["k10"] * H2II * HI / 2.0
            + k["k19"] * H2II * HM / 2.0
            + k["k22"] * HI * (HI * HI)
        )
        acoef = (
            k["k13"] * HI + k["k11"] * HII + k["k12"] * de
            + s["k29"] + s["k31"]
        )
        if anydust:
            scoef = scoef + 2.0 * rs.h2dust * HI * rhoH
        H2Ip = (scoef * dtit + H2I) / (1.0 + acoef * dtit)

        # 8) H-
        scoef = k["k7"] * HI * de
        acoef = (
            (k["k8"] + k["k15"]) * HI
            + (k["k16"] + k["k17"]) * HII
            + k["k14"] * de + k["k19"] * H2II / 2.0
            + s["k27"]
        )
        HMp = (scoef * dtit + HM) / (1.0 + acoef * dtit)

        # 9) H2+ (algebraic equilibrium; solve_rate_cool_g.F:2293-2301)
        H2IIp = 2.0 * (
            k["k9"] * HIp * HIIp
            + k["k11"] * H2Ip / 2.0 * HIIp
            + k["k17"] * HMp * HIIp
            + s["k29"] * H2Ip
        ) / (
            k["k10"] * HIp + k["k18"] * dep + k["k19"] * HMp
            + (s["k28"] + s["k30"])
        )

    # --- (D) deuterium network (solve_rate_cool_g.F:2310-2360) ---
    if ispecies > 2:
        DI, DII, HDI = f["DI"], f["DII"], f["HDI"]
        HM, H2I = f["HM"], f["H2I"]
        # DI <-> DII rate decomposition.  Per unit DI: losses to DII
        # (ionization + charge exchange, `xfer1`) and to HDI/H2
        # (`leak1`); per unit DII: losses to DI (`xfer2`) and to HDI
        # (`leak2`); HDI-sourced gains c1/c2.
        xfer1 = k["k1"] * de + k["k50"] * HII + s["k24"]
        if irt:
            xfer1 = xfer1 + kphHI
        leak1 = k["k54"] * H2I / 2.0 + k["k56"] * HM
        c1 = div_host(2.0 * k["k55"] * HDI * HI, 3.0)
        xfer2 = k["k2"] * de + k["k51"] * HI
        leak2 = k["k52"] * H2I / 2.0
        c2 = div_host(2.0 * k["k53"] * HII * HDI, 3.0)

        if cfg.deuterium_coupled_solve == 1:
            # Exact BE solve of the stiff charge-exchange pair (see the
            # `deuterium_coupled_solve` registry note):
            #   (1 + (xfer1+leak1) t) DIp  -        xfer2 t  DIIp = DI  + c1 t
            #        -xfer1 t        DIp  + (1 + (xfer2+leak2) t) DIIp = DII + c2 t
            a1 = xfer1 + leak1
            a2 = xfer2 + leak2
            det = (1.0 + a1 * dtit) * (1.0 + a2 * dtit) \
                - (xfer1 * dtit) * (xfer2 * dtit)
            DIp = (
                (DI + c1 * dtit) * (1.0 + a2 * dtit)
                + xfer2 * dtit * (DII + c2 * dtit)
            ) / det
            DIIp = (
                (DII + c2 * dtit) * (1.0 + a1 * dtit)
                + xfer1 * dtit * (DI + c1 * dtit)
            ) / det
        else:
            # reference-parity Jacobi update
            scoef = xfer2 * DII + c1
            acoef = xfer1 + leak1
            DIp = (scoef * dtit + DI) / (1.0 + acoef * dtit)

            scoef = xfer1 * DI + c2
            acoef = xfer2 + leak2
            DIIp = (scoef * dtit + DII) / (1.0 + acoef * dtit)

        scoef = 3.0 * (
            k["k52"] * DII * H2I / 2.0 / 2.0
            + k["k54"] * DI * H2I / 2.0 / 2.0
            + 2.0 * k["k56"] * DI * HM / 2.0
        )
        acoef = k["k53"] * HII + k["k55"] * HI
        HDIp = (scoef * dtit + HDI) / (1.0 + acoef * dtit)

    # --- (E) write back with floors (solve_rate_cool_g.F:2364-2396) ---
    out = dict(f)
    HIdot_prev = torch.abs(HI - HIp) / torch.clamp(dtit, min=tiny8)
    out["HI"] = torch.clamp(HIp, min=tiny)
    out["HII"] = torch.clamp(HIIp, min=tiny)
    out["HeI"] = torch.clamp(HeIp, min=tiny)
    out["HeII"] = torch.clamp(HeIIp, min=tiny)
    out["HeIII"] = torch.clamp(HeIIIp, min=1.0e-5 * tiny)

    if ispecies > 1:
        out["HM"] = torch.clamp(HMp, min=tiny)
        out["H2I"] = torch.clamp(H2Ip, min=tiny)
        out["H2II"] = torch.clamp(H2IIp, min=tiny)

    # electron density from charge conservation
    # (solve_rate_cool_g.F:2376-2384)
    de_new = out["HII"] + out["HeII"] / 4.0 + out["HeIII"] / 2.0
    if ispecies > 1:
        de_new = de_new - out["HM"] + out["H2II"] / 2.0
    dedot_prev = torch.abs(de_new - de) / torch.clamp(dtit, min=tiny8)
    out["de"] = de_new

    if ispecies > 2:
        out["DI"] = torch.clamp(DIp, min=tiny)
        out["DII"] = torch.clamp(DIIp, min=tiny)
        out["HDI"] = torch.clamp(HDIp, min=tiny)

    return out, dedot_prev, HIdot_prev


def make_consistent(cfg, f, imetal: bool):
    """Renormalize species to enforce elemental conservation and recompute
    the electron density (solve_rate_cool_g.F:2419-2534)."""
    ispecies = cfg.primordial_chemistry
    if ispecies == 0:
        return f
    fh = cfg.HydrogenFractionByMass
    dtoh = cfg.DeuteriumToHydrogenRatio
    d = f["density"]
    out = dict(f)

    metalfree = d - f["metal"] if imetal else d

    for name in ["HI", "HII", "HeI", "HeII", "HeIII"]:
        out[name] = torch.abs(f[name])
    totalH = out["HI"] + out["HII"]
    totalHe = out["HeI"] + out["HeII"] + out["HeIII"]
    if ispecies > 1:
        for name in ["HM", "H2II", "H2I"]:
            out[name] = torch.abs(f[name])
        totalH = totalH + out["HM"] + out["H2I"] + out["H2II"]

    correctH = fh * metalfree / totalH
    correctHe = (1.0 - fh) * metalfree / totalHe
    for name in ["HI", "HII"]:
        out[name] = out[name] * correctH
    for name in ["HeI", "HeII", "HeIII"]:
        out[name] = out[name] * correctHe
    if ispecies > 1:
        for name in ["HM", "H2II", "H2I"]:
            out[name] = out[name] * correctH

    if ispecies > 2:
        for name in ["DI", "DII", "HDI"]:
            out[name] = torch.abs(f[name])
        totalD = out["DI"] + out["DII"] + 2.0 / 3.0 * out["HDI"]
        correctD = fh * dtoh * metalfree / totalD
        for name in ["DI", "DII", "HDI"]:
            out[name] = out[name] * correctD

    de = out["HII"] + out["HeII"] / 4.0 + out["HeIII"] / 2.0
    if ispecies > 1:
        de = de - out["HM"] + out["H2II"] / 2.0
    out["de"] = de
    return out
