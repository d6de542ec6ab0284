"""Analytic chemistry reaction-rate formulas (vectorized, float64).

TPU-native rebuild of the reference's rate library
(grackle: src/clib/rate_functions.c:36-755).  Reaction labels follow
Abel et al. 1996 (see the reaction list in
grackle: src/clib/initialize_rates.c:33-74):

    k1  : HI + e -> HII + 2e          k14 : HM + e -> HI + 2e
    k2  : HII + e -> HI + photon      k15 : HM + HI -> 2HI + e
    k3  : HeI + e -> HeII + 2e        k16 : HM + HII -> 2HI
    k4  : HeII + e -> HeI + photon    k17 : HM + HII -> H2II + e
    k5  : HeII + e -> HeIII + 2e      k18 : H2II + e -> 2HI
    k6  : HeIII + e -> HeII + photon  k19 : H2II + HM -> H2I + HI
    k7  : HI + e -> HM + photon       k21 : 2HI + H2I -> H2I + H2I
    k8  : HI + HM -> H2I + e          k22 : 2HI + HI -> H2I + HI
    k9  : HI + HII -> H2II + photon   k23 : H2I + H2I -> H2I + 2HI
    k10 : H2II + HI -> H2I + HII      k50-k56 : deuterium network
    k11 : H2I + HII -> H2II + HI      k57 : HI + HI -> HII + HI + e
    k12 : H2I + e -> 2HI + e          k58 : HI + HeI -> HII + HeI + e
    k13 : H2I + HI -> 3HI             h2dust : 2H + grain -> H2 + grain

All functions take temperature(s) in Kelvin plus the dimensionless unit
factor and a ChemistryConfig, and are vectorized over T with NumPy (these run
once at initialization on the host; the results live on-device as tables).
"""

from __future__ import annotations

import numpy as np

from ..constants import tevk, tiny

_DHUGE_LOG = np.log(1.0e30)


def _poly_exp(logx, coeffs):
    """exp(sum_i coeffs[i] * logx**i) with explicit powers, matching the
    fit evaluation style of rate_functions.c."""
    acc = np.zeros_like(logx)
    for i, c in enumerate(coeffs):
        acc = acc + c * logx**i
    return np.exp(acc)


def _pow10_poly(logx, coeffs):
    acc = np.zeros_like(logx)
    for i, c in enumerate(coeffs):
        acc = acc + c * logx**i
    return 10.0**acc


# ---------------------------------------------------------------------------
# Collisional/radiative reaction rates
# ---------------------------------------------------------------------------

def k1_rate(T, units, cfg):
    """HI + e -> HII + 2e (Abel+96 8th-order fit; rate_functions.c:36-54)."""
    T = np.asarray(T, dtype=np.float64)
    T_ev = T / 11605.0
    logT_ev = np.log(T_ev)
    k1 = _poly_exp(logT_ev, [
        -32.71396786375, 13.53655609057, -5.739328757388,
        1.563154982022, -0.2877056004391, 0.03482559773736999,
        -0.00263197617559, 0.0001119543953861, -2.039149852002e-6,
    ]) / units
    return np.where(T_ev <= 0.8, np.maximum(tiny, k1), k1)


def k3_rate(T, units, cfg):
    """HeI + e -> HeII + 2e (rate_functions.c:57-75)."""
    T = np.asarray(T, dtype=np.float64)
    T_ev = T / 11605.0
    logT_ev = np.log(T_ev)
    val = _poly_exp(logT_ev, [
        -44.09864886561001, 23.91596563469, -10.75323019821,
        3.058038757198, -0.5685118909884001, 0.06795391233790001,
        -0.005009056101857001, 0.0002067236157507, -3.649161410833e-6,
    ]) / units
    return np.where(T_ev > 0.8, val, tiny)


def k4_rate(T, units, cfg):
    """HeII + e -> HeI + photon (rate_functions.c:78-97)."""
    T = np.asarray(T, dtype=np.float64)
    if cfg.CaseBRecombination == 1:
        return 1.26e-14 * (5.7067e5 / T) ** 0.75 / units
    T_ev = T / 11605.0
    high = (
        1.54e-9 * (1.0 + 0.3 / np.exp(8.099328789667 / T_ev))
        / (np.exp(40.49664394833662 / T_ev) * T_ev**1.5)
        + 3.92e-13 / T_ev**0.6353
    ) / units
    low = 3.92e-13 / T_ev**0.6353 / units
    return np.where(T_ev > 0.8, high, low)


def k2_rate(T, units, cfg):
    """HII + e -> HI + photon (rate_functions.c:100-129)."""
    T = np.asarray(T, dtype=np.float64)
    if cfg.CaseBRecombination == 1:
        val = (
            4.881357e-6 * T**-1.5
            * (1.0 + 1.14813e2 * T**-0.407) ** -2.242 / units
        )
        return np.where(T < 1.0e9, val, tiny)
    T_ev = T / tevk
    logT_ev = np.log(T_ev)
    high = _poly_exp(logT_ev, [
        -28.61303380689232, -0.7241125657826851, -0.02026044731984691,
        -0.002380861877349834, -0.0003212605213188796,
        -0.00001421502914054107, 4.989108920299513e-6,
        5.755614137575758e-7, -1.856767039775261e-8,
        -3.071135243196595e-9,
    ]) / units
    return np.where(T > 5500.0, high, k4_rate(T, units, cfg))


def k5_rate(T, units, cfg):
    """HeII + e -> HeIII + 2e (rate_functions.c:132-152)."""
    T = np.asarray(T, dtype=np.float64)
    T_ev = T / 11605.0
    logT_ev = np.log(T_ev)
    val = _poly_exp(logT_ev, [
        -68.71040990212001, 43.93347632635, -18.48066993568,
        4.701626486759002, -0.7692466334492, 0.08113042097303,
        -0.005324020628287001, 0.0001975705312221, -3.165581065665e-6,
    ]) / units
    return np.where(T_ev > 0.8, val, tiny)


def k6_rate(T, units, cfg):
    """HeIII + e -> HeII + photon (rate_functions.c:155-171)."""
    T = np.asarray(T, dtype=np.float64)
    if cfg.CaseBRecombination == 1:
        val = (
            7.8155e-5 * T**-1.5
            * (1.0 + 2.0189e2 * T**-0.407) ** -2.242 / units
        )
        return np.where(T < 1.0e9, val, tiny)
    return (
        3.36e-10 / np.sqrt(T) / (T / 1.0e3) ** 0.2
        / (1.0 + (T / 1.0e6) ** 0.7) / units
    ) * np.ones_like(T)


def k7_rate(T, units, cfg):
    """HI + e -> HM + photon; Stancil, Lepp & Dalgarno 1998
    (rate_functions.c:174-178)."""
    T = np.asarray(T, dtype=np.float64)
    return 3.0e-16 * (T / 3.0e2) ** 0.95 * np.exp(-T / 9.32e3) / units


def k8_rate(T, units, cfg):
    """HI + HM -> H2I + e; Kreckel et al. 2010 (rate_functions.c:181-187)."""
    T = np.asarray(T, dtype=np.float64)
    return (
        1.35e-9
        * (T**9.8493e-2 + 3.2852e-1 * T**5.5610e-1 + 2.771e-7 * T**2.1826)
        / (1.0 + 6.191e-3 * T**1.0461 + 8.9712e-11 * T**3.0424
           + 3.2576e-14 * T**3.7741)
        / units
    )


def k9_rate(T, units, cfg):
    """HI + HII -> H2II + photon; Latif et al. 2015
    (rate_functions.c:190-205)."""
    T = np.asarray(T, dtype=np.float64)
    low = 2.10e-20 * (T / 30.0) ** -0.15 / units
    T_k9 = np.minimum(T, 3.2e4)
    lt = np.log10(T_k9)
    high = 10.0 ** (-18.20 - 3.194 * lt + 1.786 * lt**2 - 0.2072 * lt**3) \
        / units
    return np.where(T < 30.0, low, high)


def k10_rate(T, units, cfg):
    """H2II + HI -> H2I + HII (rate_functions.c:208-211)."""
    T = np.asarray(T, dtype=np.float64)
    return np.full_like(T, 6.0e-10 / units)


def k11_rate(T, units, cfg):
    """H2I + HII -> H2II + HI; Savin 2004 (flag 1) or Abel+96 (flag 2)
    (rate_functions.c:214-252)."""
    T = np.asarray(T, dtype=np.float64)
    T_ev = T / 11605.0
    if cfg.h2_charge_exchange_rate == 1:
        logT = np.log(T)
        acc = np.zeros_like(T)
        for i, c in enumerate([
            -3.3232183e-07, 3.3735382e-07, -1.4491368e-07,
            3.4172805e-08, -4.7813720e-09, 3.9731542e-10,
            -1.8171411e-11, 3.5311932e-13,
        ]):
            acc = acc + c * logT**i
        val = np.exp(-21237.15 / T) * acc / units
    elif cfg.h2_charge_exchange_rate == 2:
        logT_ev = np.log(T_ev)
        val = _poly_exp(logT_ev, [
            -24.24914687731536, 3.400824447095291, -3.898003964650152,
            2.045587822403071, -0.5416182856220388, 0.0841077503763412,
            -0.007879026154483455, 0.0004138398421504563,
            -9.36345888928611e-6,
        ]) / units
    else:
        raise ValueError(
            "h2_charge_exchange_rate must be 1 or 2, got "
            f"{cfg.h2_charge_exchange_rate}"
        )
    return np.where(T_ev > 0.3, val, tiny)


def k12_rate(T, units, cfg):
    """H2I + e -> 2HI + e; Trevisan & Tennyson 2002
    (rate_functions.c:255-267)."""
    T = np.asarray(T, dtype=np.float64)
    T_ev = T / 11605.0
    val = 4.4886e-9 * T**0.109127 * np.exp(-101858.0 / T) / units
    return np.where(T_ev > 0.3, val, tiny)


def k13_rate(T, units, cfg):
    """H2I + HI -> 3HI; selected by three_body_rate
    (rate_functions.c:270-325)."""
    T = np.asarray(T, dtype=np.float64)
    tb = cfg.three_body_rate
    if tb == 0:
        T_ev = T / 11605.0
        val = (
            1.0670825e-10 * T_ev**2.012
            / (np.exp(4.463 / T_ev) * (1.0 + 0.2472 * T_ev) ** 3.512)
        )
        k13 = np.where(T_ev > 0.3, val, tiny * units)
    elif tb == 1:
        k13 = (5.24e-7 / T**0.485) * np.exp(-5.2e4 / T)
    elif tb == 2:
        k13 = 8.4e-11 * T**0.515 * np.exp(-5.2e4 / T)
    elif tb == 3:
        k13 = (1.38e-4 / T**1.025) * np.exp(-5.2e4 / T)
    elif tb == 4:
        lt = np.log10(T)
        k13 = 10.0 ** (
            -178.4239 - 68.42243 * lt + 43.20243 * lt**2
            - 4.633167 * lt**3 + 69.70086 * np.log10(1.0 + 40870.38 / T)
            - (23705.7 / T)
        )
    elif tb == 5:
        k13 = np.where(
            T <= 3000.0,
            2.4e-8 * np.exp(-5.2e4 / T),
            2.2e-6 * T**-0.565 * np.exp(-5.2e4 / T),
        )
    else:
        raise ValueError(f"three_body_rate set to unknown value: {tb}")
    return k13 / units


_K13DD_FITS = {
    # (rate_functions.c:354-398) -- 21 fitting params per idt branch.
    0: [
        -1.784239e2, -6.842243e1, 4.320243e1, -4.633167e0, 6.970086e1,
        4.087038e4, -2.370570e4, 1.288953e2, -5.391334e1, 5.315517e0,
        -1.973427e1, 1.678095e4, -2.578611e4, 1.482123e1, -4.890915e0,
        4.749030e-1, -1.338283e2, -1.164408e0, 8.227443e-1, 5.864073e-1,
        -2.056313e0,
    ],
    1: [
        -1.427664e2, 4.270741e1, -2.027365e0, -2.582097e-1, 2.136094e1,
        2.753531e4, -2.146779e4, 6.034928e1, -2.743096e1, 2.676150e0,
        -1.128215e1, 1.425455e4, -2.312520e4, 9.305564e0, -2.464009e0,
        1.985955e-1, 7.430600e2, -1.174242e0, 7.502286e-1, 2.358848e-1,
        2.937507e0,
    ],
}


def k13dd_rate(T, units, cfg):
    """Density-dependent H2 dissociation coefficients, Martin et al. 1996
    (rate_functions.c:329-448).

    Returns array of shape T.shape + (14,): 7 coefficients for direct
    collisional dissociation (idt=0) then 7 for dissociative tunneling.
    """
    T = np.asarray(T, dtype=np.float64)
    T = np.clip(T, 500.0, 1.0e6)
    log10_T = np.log10(T)
    out = np.empty(T.shape + (14,), dtype=np.float64)
    for idt in (0, 1):
        p = _K13DD_FITS[idt]
        a = (p[0] + p[1] * log10_T + p[2] * log10_T**2
             + p[3] * log10_T**3 + p[4] * np.log10(1.0 + p[5] / T))
        a1 = p[6] / T
        b = (p[7] + p[8] * log10_T + p[9] * log10_T**2
             + p[10] * np.log10(1.0 + p[11] / T))
        b1 = p[12] / T
        c = p[13] + p[14] * log10_T + p[15] * log10_T**2 + p[16] / T
        c1 = p[17] + c
        d = (p[18] + p[19] * np.exp(-T / 1850.0)
             + p[20] * np.exp(-T / 440.0))
        out[..., idt * 7 + 0] = a - np.log10(units)
        out[..., idt * 7 + 1] = a - b
        out[..., idt * 7 + 2] = a1
        out[..., idt * 7 + 3] = a1 - b1
        out[..., idt * 7 + 4] = 10.0**c
        out[..., idt * 7 + 5] = 10.0**c1
        out[..., idt * 7 + 6] = d
    return out


def k14_rate(T, units, cfg):
    """HM + e -> HI + 2e (rate_functions.c:451-471)."""
    T = np.asarray(T, dtype=np.float64)
    T_ev = T / 11605.0
    logT_ev = np.log(T_ev)
    val = _poly_exp(logT_ev, [
        -18.01849334273, 2.360852208681, -0.2827443061704,
        0.01623316639567, -0.03365012031362999, 0.01178329782711,
        -0.001656194699504, 0.0001068275202678, -2.631285809207e-6,
    ]) / units
    return np.where(T_ev > 0.04, val, tiny)


def k15_rate(T, units, cfg):
    """HM + HI -> 2HI + e (rate_functions.c:474-495)."""
    T = np.asarray(T, dtype=np.float64)
    T_ev = T / 11605.0
    logT_ev = np.log(T_ev)
    high = _poly_exp(logT_ev, [
        -20.37260896533324, 1.139449335841631, -0.1421013521554148,
        0.00846445538663, -0.0014327641212992, 0.0002012250284791,
        0.0000866396324309, -0.00002585009680264, 2.4555011970392e-6,
        -8.06838246118e-8,
    ]) / units
    low = 2.56e-9 * T_ev**1.78186 / units
    return np.where(T_ev > 0.1, high, low)


def k16_rate(T, units, cfg):
    """HM + HII -> 2HI; Croft et al. 1999 (rate_functions.c:498-502)."""
    T = np.asarray(T, dtype=np.float64)
    return 2.4e-6 * (1.0 + T / 2.0e4) / np.sqrt(T) / units


def k17_rate(T, units, cfg):
    """HM + HII -> H2II + e (rate_functions.c:505-514)."""
    T = np.asarray(T, dtype=np.float64)
    return np.where(
        T > 1.0e4,
        4.0e-4 * T**-1.4 * np.exp(-15100.0 / T) / units,
        1.0e-8 * T**-0.4 / units,
    )


def k18_rate(T, units, cfg):
    """H2II + e -> 2HI (rate_functions.c:517-526)."""
    T = np.asarray(T, dtype=np.float64)
    return np.where(
        T > 617.0, 1.32e-6 * T**-0.76 / units, 1.0e-8 / units
    )


def k19_rate(T, units, cfg):
    """H2II + HM -> H2I + HI (rate_functions.c:529-532)."""
    T = np.asarray(T, dtype=np.float64)
    return 5.0e-7 * np.sqrt(100.0 / T) / units


def k20_rate(T, units, cfg):
    """Unused (rate_functions.c:535-538)."""
    T = np.asarray(T, dtype=np.float64)
    return np.full_like(T, tiny)


def k21_rate(T, units, cfg):
    """2HI + H2I -> H2I + H2I (rate_functions.c:541-543)."""
    T = np.asarray(T, dtype=np.float64)
    return 2.8e-31 * T**-0.6 / units


def k22_rate(T, units, cfg):
    """2HI + HI -> H2I + HI; selected by three_body_rate
    (rate_functions.c:546-590)."""
    T = np.asarray(T, dtype=np.float64)
    tb = cfg.three_body_rate
    if tb == 0:
        k22 = np.where(
            T <= 300.0,
            1.3e-32 * (T / 300.0) ** -0.38,
            1.3e-32 * (T / 300.0) ** -1.0,
        )
    elif tb == 1:
        k22 = 5.5e-29 / T
    elif tb == 2:
        k22 = np.full_like(T, 8.8e-33)
    elif tb == 3:
        k22 = 1.44e-26 / T**1.54
    elif tb == 4:
        k22 = 7.7e-31 / T**0.464
    elif tb == 5:
        k22 = (6e-32 / T**0.25) + (2e-31 / T**0.5)
    else:
        raise ValueError(f"three_body_rate set to unknown value: {tb}")
    return k22 / units


def k23_rate(T, units, cfg):
    """H2I + H2I -> H2I + 2HI (rate_functions.c:593-599)."""
    T = np.asarray(T, dtype=np.float64)
    k23 = (
        (8.125e-8 / np.sqrt(T)) * np.exp(-52000.0 / T)
        * (1.0 - np.exp(-6000.0 / T)) / units
    )
    return np.maximum(tiny, k23)


def k50_rate(T, units, cfg):
    """HII + DI -> HI + DII; Savin 2002 (rate_functions.c:602-612)."""
    T = np.asarray(T, dtype=np.float64)
    low = (2.0e-10 * T**0.402 * np.exp(-3.71e1 / T)
           - 3.31e-17 * T**1.48) / units
    high = 2.5e-8 * (T / 2.0e5) ** 0.402 / units
    return np.where(T <= 2.0e5, low, high)


def k51_rate(T, units, cfg):
    """HI + DII -> HII + DI; Savin 2002 (rate_functions.c:615-620)."""
    T = np.asarray(T, dtype=np.float64)
    return (2.06e-10 * T**0.396 * np.exp(-3.30e1 / T)
            + 2.03e-9 * T**-0.332) / units


def k52_rate(T, units, cfg):
    """H2I + DII -> HDI + HII; Galli & Palla 2002
    (rate_functions.c:623-633)."""
    T = np.asarray(T, dtype=np.float64)
    lt = np.log10(T)
    low = 1.0e-9 * (0.417 + 0.846 * lt - 0.137 * lt**2) / units
    return np.where(T <= 1e4, low, 1.609e-9 / units)


def k53_rate(T, units, cfg):
    """HDI + HII -> H2I + DII; Galli & Palla 2002
    (rate_functions.c:636-640)."""
    T = np.asarray(T, dtype=np.float64)
    return 1.1e-9 * np.exp(-4.88e2 / T) / units


def k54_rate(T, units, cfg):
    """H2I + DI -> HDI + HI; Clark et al. 2011 (rate_functions.c:643-655).

    NOTE: the reference does not divide this rate by ``units`` (the fit
    returns cgs); we reproduce that behavior exactly for parity.
    """
    T = np.asarray(T, dtype=np.float64)
    lt = np.log10(T)
    low = _pow10_poly(lt, [
        -5.64737e1, 5.88886, 7.19692, 2.25069, -2.16903, 3.17887e-1,
    ])
    high = 3.17e-10 * np.exp(-5.207e3 / T)
    return np.where(T <= 2.0e3, low, high)


def k55_rate(T, units, cfg):
    """HDI + HI -> H2I + DI; Galli & Palla 2002 with Ripamonti 2007
    low-T fix (rate_functions.c:658-669)."""
    T = np.asarray(T, dtype=np.float64)
    high = 5.25e-11 * np.exp(-4.43e3 / T + 1.739e5 / T**2) / units
    return np.where(T <= 2.0e2, 1.08e-22 / units, high)


def k56_rate(T, units, cfg):
    """DI + HM -> HDI + e; same as k8 (rate_functions.c:672-678)."""
    return k8_rate(T, units, cfg)


def k57_rate(T, units, cfg):
    """HI + HI -> HII + HI + e; Lenzuni et al. 1991
    (rate_functions.c:681-690)."""
    T = np.asarray(T, dtype=np.float64)
    val = 1.2e-17 * T**1.2 * np.exp(-1.578e5 / T) / units
    return np.where(T > 3.0e3, val, tiny)


def k58_rate(T, units, cfg):
    """HI + HeI -> HII + HeI + e; Lenzuni et al. 1991
    (rate_functions.c:693-702)."""
    T = np.asarray(T, dtype=np.float64)
    val = 1.75e-17 * T**1.3 * np.exp(-1.578e5 / T) / units
    return np.where(T > 3.0e3, val, tiny)


def h2dust_rate(T, T_dust, units, cfg):
    """2H + grain -> H2 + grain; Omukai 2000 (flag 1) or
    Hollenbach & McKee 1979 (flag 2) (rate_functions.c:705-734)."""
    T = np.asarray(T, dtype=np.float64)
    T_dust = np.asarray(T_dust, dtype=np.float64)
    fgr = 0.009387
    if cfg.h2_dust_rate == 1:
        h2dust = (
            6.0e-17 / fgr * (T / 300.0) ** 0.5
            * (1.0 + np.exp(7.5e2 * ((1.0 / 75.0) - (1.0 / T_dust)))) ** -1.0
            * (1.0 + (4.0e-2 * (T + T_dust) ** 0.5)
               + (2.0e-3 * T) + (8.0e-6 * T**2.0)) ** -1.0
        )
    else:
        T_2 = T / 1.0e2
        T_dust_2 = T_dust / 1.0e2
        h2dust = (
            3.0e-17 / fgr * T_2**0.5
            / (1.0 + 0.4 * (T_2 + T_dust_2) ** 0.5
               + 0.2 * T_2 + 8.0e-2 * T_2**2.0)
        )
    return h2dust / units


def n_cr_n_rate(T, units, cfg):
    """H2 formation heating term, Omukai 2000 Eq. 23
    (rate_functions.c:737-741).  Dimensionless (ignores units)."""
    T = np.asarray(T, dtype=np.float64)
    return 1.0e6 * T**-0.5


def n_cr_d1_rate(T, units, cfg):
    """(rate_functions.c:744-748)"""
    T = np.asarray(T, dtype=np.float64)
    return 1.6 * np.exp(-((400.0 / T) ** 2.0))


def n_cr_d2_rate(T, units, cfg):
    """(rate_functions.c:751-755)"""
    T = np.asarray(T, dtype=np.float64)
    return 1.4 * np.exp(-12000.0 / (T + 1200.0))
