"""Analytic cooling/heating rate formulas (vectorized, float64).

TPU-native rebuild of the cooling-rate fit library
(grackle: src/clib/rate_functions.c:758-1336).  These fill the log-T lookup
tables consumed by the cooling kernel; evaluation on-device is a vectorized
gather+lerp (see grackle_tpu.ops.lookup).
"""

from __future__ import annotations

import numpy as np

from ..constants import kboltz, mh, tiny
from ._cie_data import CIE_RATE, T_CIE

_DHUGE_LOG = np.log(1.0e30)


def _exp_clamped(x):
    """exp(-min(log(dhuge), x)) as used throughout rate_functions.c."""
    return np.exp(-np.minimum(_DHUGE_LOG, x))


# --- collisional excitation (Black 1981; Cen 1992) -------------------------

def ceHI_rate(T, units, cfg):
    """(rate_functions.c:758-766)"""
    T = np.asarray(T, dtype=np.float64)
    if cfg.collisional_excitation_rates != 1:
        return np.full_like(T, tiny)
    return 7.5e-19 * _exp_clamped(118348.0 / T) \
        / (1.0 + np.sqrt(T / 1.0e5)) / units


def ceHeI_rate(T, units, cfg):
    """(rate_functions.c:769-777)"""
    T = np.asarray(T, dtype=np.float64)
    if cfg.collisional_excitation_rates != 1:
        return np.full_like(T, tiny)
    return 9.1e-27 * _exp_clamped(13179.0 / T) * T**-0.1687 \
        / (1.0 + np.sqrt(T / 1.0e5)) / units


def ceHeII_rate(T, units, cfg):
    """(rate_functions.c:780-788)"""
    T = np.asarray(T, dtype=np.float64)
    if cfg.collisional_excitation_rates != 1:
        return np.full_like(T, tiny)
    return 5.54e-17 * _exp_clamped(473638.0 / T) * T**-0.3970 \
        / (1.0 + np.sqrt(T / 1.0e5)) / units


# --- collisional ionization (Cen 1992; Abel 1996) --------------------------

def ciHeIS_rate(T, units, cfg):
    """(rate_functions.c:791-799)"""
    T = np.asarray(T, dtype=np.float64)
    if cfg.collisional_ionisation_rates != 1:
        return np.full_like(T, tiny)
    return 5.01e-27 * T**-0.1687 / (1.0 + np.sqrt(T / 1.0e5)) \
        * _exp_clamped(55338.0 / T) / units


def ciHI_rate(T, units, cfg):
    """(rate_functions.c:802-810)"""
    from .reactions import k1_rate
    T = np.asarray(T, dtype=np.float64)
    if cfg.collisional_ionisation_rates != 1:
        return np.full_like(T, tiny)
    return 2.18e-11 * k1_rate(T, 1.0, cfg) / units


def ciHeI_rate(T, units, cfg):
    """(rate_functions.c:813-821)"""
    from .reactions import k3_rate
    T = np.asarray(T, dtype=np.float64)
    if cfg.collisional_ionisation_rates != 1:
        return np.full_like(T, tiny)
    return 3.94e-11 * k3_rate(T, 1.0, cfg) / units


def ciHeII_rate(T, units, cfg):
    """(rate_functions.c:824-832)"""
    from .reactions import k5_rate
    T = np.asarray(T, dtype=np.float64)
    if cfg.collisional_ionisation_rates != 1:
        return np.full_like(T, tiny)
    return 8.72e-11 * k5_rate(T, 1.0, cfg) / units


# --- recombination cooling (Hui & Gnedin 1997; Cen 1992) -------------------

def reHII_rate(T, units, cfg):
    """(rate_functions.c:835-854)"""
    T = np.asarray(T, dtype=np.float64)
    if cfg.recombination_cooling_rates != 1:
        return np.full_like(T, tiny)
    lambdaHI = 2.0 * 157807.0 / T
    if cfg.CaseBRecombination == 1:
        return 3.435e-30 * T * lambdaHI**1.970 \
            / (1.0 + (lambdaHI / 2.25) ** 0.376) ** 3.720 / units
    return 1.778e-29 * T * lambdaHI**1.965 \
        / (1.0 + (lambdaHI / 0.541) ** 0.502) ** 2.697 / units


def reHeII1_rate(T, units, cfg):
    """(rate_functions.c:857-874)"""
    T = np.asarray(T, dtype=np.float64)
    if cfg.recombination_cooling_rates != 1:
        return np.full_like(T, tiny)
    lambdaHeII = 2.0 * 285335.0 / T
    if cfg.CaseBRecombination == 1:
        return 1.26e-14 * kboltz * T * lambdaHeII**0.75 / units
    return 3e-14 * kboltz * T * lambdaHeII**0.654 / units


def reHeII2_rate(T, units, cfg):
    """Dielectronic recombination, Cen 1992 (rate_functions.c:877-888)."""
    T = np.asarray(T, dtype=np.float64)
    if cfg.recombination_cooling_rates != 1:
        return np.full_like(T, tiny)
    return 1.24e-13 * T**-1.5 * _exp_clamped(470000.0 / T) \
        * (1.0 + 0.3 * _exp_clamped(94000.0 / T)) / units


def reHeIII_rate(T, units, cfg):
    """(rate_functions.c:891-910)"""
    T = np.asarray(T, dtype=np.float64)
    if cfg.recombination_cooling_rates != 1:
        return np.full_like(T, tiny)
    lambdaHeIII = 2.0 * 631515.0 / T
    if cfg.CaseBRecombination == 1:
        return 8.0 * 3.435e-30 * T * lambdaHeIII**1.970 \
            / (1.0 + (lambdaHeIII / 2.25) ** 0.376) ** 3.720 / units
    return 8.0 * 1.778e-29 * T * lambdaHeIII**1.965 \
        / (1.0 + (lambdaHeIII / 0.541) ** 0.502) ** 2.697 / units


def brem_rate(T, units, cfg):
    """Bremsstrahlung, Black 1981 / Spitzer & Hart 1979
    (rate_functions.c:913-922)."""
    T = np.asarray(T, dtype=np.float64)
    if cfg.bremsstrahlung_cooling_rates != 1:
        return np.full_like(T, tiny)
    return 1.43e-27 * np.sqrt(T) \
        * (1.1 + 0.34 * np.exp(-((5.5 - np.log10(T)) ** 2) / 3.0)) / units


# --- Lepp & Shull molecular-H cooling fits ---------------------------------

def vibh_rate(T, units, cfg):
    """(rate_functions.c:925-936) — note the reference discards its
    low/high-T branch variable; the returned fit matches exactly."""
    T = np.asarray(T, dtype=np.float64)
    return 1.1e-18 * _exp_clamped(6744.0 / T) / units


def hyd01k_rate(T, units, cfg):
    """(rate_functions.c:939-951)"""
    T = np.asarray(T, dtype=np.float64)
    par_dum = np.where(
        T > 1635.0,
        1.0e-12 * np.sqrt(T) * np.exp(-1000.0 / T),
        1.4e-13 * np.exp((T / 125.0) - (T / 577.0) ** 2),
    )
    return par_dum * _exp_clamped(8.152e-13 / (kboltz * T)) / units


def h2k01_rate(T, units, cfg):
    """(rate_functions.c:954-960)"""
    T = np.asarray(T, dtype=np.float64)
    par_dum = 8.152e-13 * (
        4.2 / (kboltz * (T + 1190.0)) + 1.0 / (kboltz * T)
    )
    return 1.45e-12 * np.sqrt(T) * np.exp(
        -np.minimum(_DHUGE_LOG, par_dum)) / units


def rotl_rate(T, units, cfg):
    """(rate_functions.c:963-972)"""
    T = np.asarray(T, dtype=np.float64)
    par_x = np.log10(T / 1.0e4)
    return np.where(
        T > 4031.0,
        1.38e-22 * np.exp(-9243.0 / T) / units,
        10.0 ** (-22.9 - 0.553 * par_x - 1.148 * par_x**2) / units,
    )


def roth_rate(T, units, cfg):
    """(rate_functions.c:975-984)"""
    T = np.asarray(T, dtype=np.float64)
    par_x = np.log10(T / 1.0e4)
    return np.where(
        T > 1087.0,
        3.9e-19 * np.exp(-6118.0 / T) / units,
        10.0 ** (-19.24 + 0.474 * par_x - 1.247 * par_x**2) / units,
    )


# --- Galli & Palla 1999 fits -----------------------------------------------

def GP99LowDensityLimit_rate(T, units, cfg):
    """(rate_functions.c:987-996)"""
    T = np.asarray(T, dtype=np.float64)
    tm = np.clip(T, 13.0, 1.0e5)
    lt = np.log10(tm)
    return 10.0 ** (
        -103.0 + 97.59 * lt - 48.05 * lt**2 + 10.8 * lt**3
        - 0.9032 * lt**4
    ) / units


def GP99HighDensityLimit_rate(T, units, cfg):
    """(rate_functions.c:999-1012)"""
    T = np.asarray(T, dtype=np.float64)
    tm = np.clip(T, 13.0, 1.0e5)
    t3 = tm / 1000.0
    HDLR = (9.5e-22 * t3**3.76) / (1.0 + 0.12 * t3**2.1) \
        * np.exp(-((0.13 / t3) ** 3)) + 3.0e-24 * np.exp(-0.51 / t3)
    HDLV = 6.7e-19 * np.exp(-5.86 / t3) + 1.6e-18 * np.exp(-11.7 / t3)
    return (HDLR + HDLV) / units


# --- Glover & Abel 2008 low-density H2 cooling -----------------------------

def _ga_logt3(T):
    tm = np.clip(np.asarray(T, dtype=np.float64), 10.0, 1.0e4)
    return tm, np.log10(tm / 1.0e3)


def GAHI_rate(T, units, cfg):
    """Excitation by HI: Lique 2015 (flag 1) or Glover & Abel 2008 (flag 2)
    (rate_functions.c:1015-1081)."""
    tm, lt3 = _ga_logt3(T)
    if cfg.h2_h_cooling_rate == 1:
        val = 10.0 ** (
            -24.07950609 + 4.54182810 * lt3 - 2.40206896 * lt3**2
            - 0.75355292 * lt3**3 + 4.69258178 * lt3**4
            - 2.79573574 * lt3**5 - 3.14766075 * lt3**6
            + 2.50751333 * lt3**7
        ) / units
        return np.where(tm < 1e2, 0.0, val)
    elif cfg.h2_h_cooling_rate == 2:
        low = 10.0 ** (
            -16.818342 + 37.383713 * lt3 + 58.145166 * lt3**2
            + 48.656103 * lt3**3 + 20.159831 * lt3**4
            + 3.8479610 * lt3**5
        ) / units
        mid = 10.0 ** (
            -24.311209 + 3.5692468 * lt3 - 11.332860 * lt3**2
            - 27.850082 * lt3**3 - 21.328264 * lt3**4
            - 4.2519023 * lt3**5
        ) / units
        high = 10.0 ** (
            -24.311209 + 4.6450521 * lt3 - 3.7209846 * lt3**2
            + 5.9369081 * lt3**3 - 5.5108047 * lt3**4
            + 1.5538288 * lt3**5
        ) / units
        return np.where(tm < 1.0e2, low, np.where(tm < 1.0e3, mid, high))
    raise ValueError(
        f"h2_h_cooling_rate must be 1 or 2, got {cfg.h2_h_cooling_rate}"
    )


def GAH2_rate(T, units, cfg):
    """(rate_functions.c:1084-1097)"""
    _, lt3 = _ga_logt3(T)
    return 10.0 ** (
        -23.962112 + 2.09433740 * lt3 - 0.77151436 * lt3**2
        + 0.43693353 * lt3**3 - 0.14913216 * lt3**4
        - 0.033638326 * lt3**5
    ) / units


def GAHe_rate(T, units, cfg):
    """(rate_functions.c:1100-1113)"""
    _, lt3 = _ga_logt3(T)
    return 10.0 ** (
        -23.689237 + 2.1892372 * lt3 - 0.81520438 * lt3**2
        + 0.29036281 * lt3**3 - 0.16596184 * lt3**4
        + 0.19191375 * lt3**5
    ) / units


def GAHp_rate(T, units, cfg):
    """Honvault et al. 2011/2012 (rate_functions.c:1116-1129)."""
    _, lt3 = _ga_logt3(T)
    return 10.0 ** (
        -22.089523 + 1.5714711 * lt3 + 0.015391166 * lt3**2
        - 0.23619985 * lt3**3 - 0.51002221 * lt3**4
        + 0.32168730 * lt3**5
    ) / units


def GAel_rate(T, units, cfg):
    """Yoon et al. 2008 (rate_functions.c:1132-1162)."""
    tm, lt3 = _ga_logt3(T)
    mid = 10.0 ** (
        -21.928796 + 16.815730 * lt3 + 96.743155 * lt3**2
        + 343.19180 * lt3**3 + 734.71651 * lt3**4
        + 983.67576 * lt3**5 + 801.81247 * lt3**6
        + 364.14446 * lt3**7 + 70.609154 * lt3**8
    ) / units
    high = 10.0 ** (
        -22.921189 + 1.6802758 * lt3 + 0.93310622 * lt3**2
        + 4.0406627 * lt3**3 - 4.7274036 * lt3**4
        - 8.8077017 * lt3**5 + 8.9167183 * lt3**6
        + 6.4380698 * lt3**7 - 6.3701156 * lt3**8
    ) / units
    return np.where(tm < 100.0, 0.0, np.where(tm < 500.0, mid, high))


def H2LTE_rate(T, units, cfg):
    """Glover 2015 LTE fit (rate_functions.c:1165-1186)."""
    tm, lt3 = _ga_logt3(T)
    low = 7.0e-27 * tm**1.5 * np.exp(-512.0 / tm) / units
    high = 10.0 ** (
        -20.584225 + 5.0194035 * lt3 - 1.5738805 * lt3**2
        - 4.7155769 * lt3**3 + 2.4714161 * lt3**4
        + 5.4710750 * lt3**5 - 3.9467356 * lt3**6
        - 2.2148338 * lt3**7 + 1.8161874 * lt3**8
    ) / units
    return np.where(tm < 1.0e2, low, high)


# --- HD cooling ------------------------------------------------------------

def HDlte_rate(T, units, cfg):
    """Coppola et al. 2011 (rate_functions.c:1189-1205)."""
    T = np.asarray(T, dtype=np.float64)
    tm = np.clip(T, 10.0, 3.0e4)
    lt = np.log10(tm)
    HDlte = (-55.5725 + 56.649 * lt - 37.9102 * lt**2
             + 12.698 * lt**3 - 2.02424 * lt**4 + 0.122393 * lt**5)
    return 10.0 ** np.minimum(HDlte, 0.0) / units


def HDlow_rate(T, units, cfg):
    """Wrathmall, Gusdorf & Flower 2007 (rate_functions.c:1208-1222)."""
    T = np.asarray(T, dtype=np.float64)
    tm = np.clip(T, 1.0e1, 6.0e3)
    lt3 = np.log10(tm / 1.0e3)
    HDlow = (-23.175780 + 1.5035261 * lt3 + 0.40871403 * lt3**2
             + 0.17849311 * lt3**3 - 0.077291388 * lt3**4
             + 0.10031326 * lt3**5)
    return 10.0**HDlow / units


# --- CIE cooling (Ripamonti & Abel 2003) -----------------------------------

_T_CIE = np.asarray(T_CIE, dtype=np.float64)
_CIE_TABLE = np.asarray(CIE_RATE, dtype=np.float64)


def cie_thin_cooling_rate(T):
    """Optically-thin CIE cooling rate via linear interpolation of the
    288-point embedded table, with power-law extrapolation at the ends
    (rate_functions.c:1225-1277)."""
    T = np.asarray(T, dtype=np.float64)
    low = _CIE_TABLE[0] * (T / _T_CIE[0]) ** 4
    high = _CIE_TABLE[287] * (T / _T_CIE[287]) ** 3
    # interior: linear interpolation matching the reference's bisection
    idx = np.clip(np.searchsorted(_T_CIE, T, side="right") - 1, 0, 286)
    t0, t1 = _T_CIE[idx], _T_CIE[idx + 1]
    c0, c1 = _CIE_TABLE[idx], _CIE_TABLE[idx + 1]
    mid = (c1 * (T - t0) + c0 * (t1 - T)) / (t1 - t0)
    return np.where(T <= _T_CIE[0], low, np.where(T >= _T_CIE[287], high, mid))


def cieco_rate(T, units, cfg):
    """(rate_functions.c:1280-1285)"""
    return cie_thin_cooling_rate(T) * (mh / 2.0) / units


# --- dust ------------------------------------------------------------------

def gasGrain_rate(T, units, cfg):
    """Gas-to-grain energy transfer, Hollenbach & McKee 1989 Eq. 2.15
    (rate_functions.c:1288-1297)."""
    T = np.asarray(T, dtype=np.float64)
    fgr = 0.009387
    grain_coeff = 1.2e-31 * 1.0e3**-0.5 / fgr
    return grain_coeff * T**0.5 * (1.0 - 0.8 * np.exp(-75.0 / T)) / units


def regr_rate(T, units, cfg):
    """Grain recombination cooling, Wolfire et al. 1995 Eq. 9
    (rate_functions.c:1300-1305)."""
    T = np.asarray(T, dtype=np.float64)
    grbeta = 0.74 / T**0.068
    return 4.65e-30 * T ** (0.94 + 0.5 * grbeta) / units


# --- temperature-independent scalars ---------------------------------------

def comp_rate(units, cfg):
    """Compton cooling coefficient, Peebles 1971
    (rate_functions.c:1310-1313)."""
    return 5.65e-36 / units


def gammah_rate(units, cfg):
    """Photoelectric heating scalar (rate_functions.c:1316-1325)."""
    if cfg.photoelectric_heating <= 1:
        return cfg.photoelectric_heating_rate / units
    return 1.0e-24 / units


def gamma_isrf_rate(units, cfg):
    """ISRF dust heating, Krumholz 2014 Eq. B15; stays CGS because the dust
    temperature solve works in CGS (rate_functions.c:1328-1336)."""
    fgr = 0.009387
    return 3.9e-24 / mh / fgr
