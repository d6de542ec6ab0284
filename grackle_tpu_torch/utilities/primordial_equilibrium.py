"""Analytic collisional-ionization-equilibrium abundances and cooling.

Mirror of grackle: src/python/pygrackle/utilities/primordial_equilibrium.py
(Katz et al. 1996 / Cen 1992 'cen' rates and the Abel+96-fit 'enzo' rates)
used by the 6-species equilibrium answer test.
"""

from __future__ import annotations

import numpy as np


def _abel_fit(T, coeffs):
    log_T_eV = np.log(np.asarray(T, dtype=np.float64) / 11605.0)
    acc = np.zeros_like(log_T_eV)
    for i, c in enumerate(coeffs):
        acc += c * log_T_eV**i
    return np.exp(acc)


# --- recombination rates ---

def alphaHII(T, rates="enzo"):
    T = np.asarray(T, dtype=np.float64)
    if rates == "cen":
        return (8.4e-11 * T**-0.5 * (T * 1e-3) ** -0.2
                / (1.0 + (T * 1e-6) ** 0.7))
    high = _abel_fit(T, [
        -28.61303380689232, -0.7241125657826851, -0.02026044731984691,
        -0.002380861877349834, -0.0003212605213188796,
        -0.00001421502914054107, 4.989108920299513e-6,
        5.755614137575758e-7, -1.856767039775261e-8,
        -3.071135243196595e-9,
    ])
    return np.where(T > 5500.0, high, alphaHeII(T, rates=rates))


def alphaHeII(T, rates="enzo"):
    T = np.asarray(T, dtype=np.float64)
    if rates == "cen":
        return 1.5e-10 * T**-0.6353
    T_eV = T / 11605.0
    return (1.54e-9 * (1.0 + 0.3 / np.exp(8.099328789667 / T_eV))
            / (np.exp(40.49664394833662 / T_eV) * T_eV**1.5)
            + 3.92e-13 / T_eV**0.6353)


def alphaHeIII(T, rates="enzo"):
    T = np.asarray(T, dtype=np.float64)
    return (3.36e-10 * T**-0.5 * (T * 1e-3) ** -0.2
            / (1.0 + (T * 1e-6) ** 0.7))


def alphad(T, rates="enzo"):
    T = np.asarray(T, dtype=np.float64)
    if rates == "cen":
        return (1.9e-3 * T**-1.5 * np.exp(-470000.0 / T)
                * (1.0 + 0.3 * np.exp(-94000.0 / T)))
    return np.zeros_like(T)


# --- collisional ionization rates ---

def GammaeHI(T, rates="enzo"):
    T = np.asarray(T, dtype=np.float64)
    if rates == "cen":
        return (5.85e-11 * T**0.5 * np.exp(-157809.1 / T)
                / (1.0 + (T * 1e-5) ** 0.5))
    return _abel_fit(T, [
        -32.71396786375, 13.53655609057, -5.739328757388,
        1.563154982022, -0.2877056004391, 0.03482559773736999,
        -0.00263197617559, 0.0001119543953861, -2.039149852002e-6,
    ])


def GammaeHeI(T, rates="enzo"):
    T = np.asarray(T, dtype=np.float64)
    if rates == "cen":
        return (2.38e-11 * T**0.5 * np.exp(-285335.4 / T)
                / (1.0 + (T * 1e-5) ** 0.5))
    return _abel_fit(T, [
        -44.09864886561001, 23.91596563469, -10.75323019821,
        3.058038757198, -0.5685118909884001, 0.06795391233790001,
        -0.005009056101857001, 0.0002067236157507, -3.649161410833e-6,
    ])


def GammaeHeII(T, rates="enzo"):
    T = np.asarray(T, dtype=np.float64)
    if rates == "cen":
        return (5.68e-12 * T**0.5 * np.exp(-631515.0 / T)
                / (1.0 + (T * 1e-5) ** 0.5))
    return _abel_fit(T, [
        -68.71040990212001, 43.93347632635, -18.48066993568,
        4.701626486759002, -0.7692466334492, 0.08113042097303,
        -0.005324020628287001, 0.0001975705312221, -3.165581065665e-6,
    ])


# --- equilibrium abundances ---

def nHI(T, nH, rates="enzo"):
    a = alphaHII(T, rates=rates)
    return nH * a / (a + GammaeHI(T, rates=rates))


def nHII(T, nH, rates="enzo"):
    return nH - nHI(T, nH, rates=rates)


def nHeII(T, nH, Y=0.24, rates="enzo"):
    y = Y / (4 - 4 * Y)
    a2 = alphaHeII(T, rates=rates) + alphad(T, rates=rates)
    return y * nH / (
        1.0 + a2 / GammaeHeI(T, rates=rates)
        + GammaeHeII(T, rates=rates) / alphaHeIII(T, rates=rates)
    )


def nHeI(T, nH, Y=0.24, rates="enzo"):
    return (nHeII(T, nH, Y=Y, rates=rates)
            * (alphaHeII(T, rates=rates) + alphad(T, rates=rates))
            / GammaeHeI(T, rates=rates))


def nHeIII(T, nH, Y=0.24, rates="enzo"):
    return (nHeII(T, nH, Y=Y, rates=rates) * GammaeHeII(T, rates=rates)
            / alphaHeIII(T, rates=rates))


def ne(T, nH, Y=0.24, rates="enzo"):
    return (nHII(T, nH, rates=rates) + nHeII(T, nH, Y=Y, rates=rates)
            + 2 * nHeIII(T, nH, rates=rates))


# --- cooling terms (erg/s/cm^3) ---

def ceHI(T, nH, rates="enzo"):
    return (7.50e-19 * ne(T, nH, rates=rates) * nHI(T, nH, rates=rates)
            * np.exp(-118348.0 / T) / (1.0 + (T * 1e-5) ** 0.5))


def ceHeII(T, nH, Y=0.24, rates="enzo"):
    return (5.54e-17 * ne(T, nH, rates=rates)
            * nHeII(T, nH, Y=Y, rates=rates)
            * T**-0.397 * np.exp(-473638.0 / T)
            / (1.0 + (T * 1e-5) ** 0.5))


def ciHI(T, nH, rates="enzo"):
    if rates == "cen":
        return (1.27e-21 * ne(T, nH, rates=rates)
                * nHI(T, nH, rates=rates)
                * T**0.5 * np.exp(-157809.1 / T)
                / (1.0 + (T * 1e-5) ** 0.5))
    return (2.18e-11 * GammaeHI(T, rates=rates) * ne(T, nH, rates=rates)
            * nHI(T, nH, rates=rates))


def ciHeI(T, nH, rates="enzo"):
    if rates == "cen":
        return (9.38e-22 * ne(T, nH, rates=rates)
                * nHeI(T, nH, rates=rates)
                * T**0.5 * np.exp(-285335.4 / T)
                / (1.0 + (T * 1e-5) ** 0.5))
    return (3.94e-11 * GammaeHeI(T, rates=rates)
            * ne(T, nH, rates=rates) * nHeI(T, nH, rates=rates))


def ciHeII(T, nH, Y=0.24, rates="enzo"):
    if rates == "cen":
        return (4.95e-22 * ne(T, nH, rates=rates)
                * nHeII(T, nH, Y=Y, rates=rates)
                * T**0.5 * np.exp(-631515.0 / T)
                / (1.0 + (T * 1e-5) ** 0.5))
    return (8.72e-11 * GammaeHeII(T, rates=rates)
            * ne(T, nH, rates=rates) * nHeII(T, nH, Y=Y, rates=rates))


def rHII(T, nH, rates="enzo"):
    return (8.70e-27 * ne(T, nH, rates=rates) * nHII(T, nH, rates=rates)
            * T**0.5 * (T * 1e-3) ** -0.2 / (1.0 + (T * 1e-6) ** 0.7))


def rHeII(T, nH, Y=0.24, rates="enzo"):
    return (1.55e-26 * ne(T, nH, rates=rates)
            * nHeII(T, nH, Y=Y, rates=rates) * T**0.3647)


def rHeIII(T, nH, rates="enzo"):
    return (3.48e-26 * ne(T, nH, rates=rates)
            * nHeIII(T, nH, rates=rates) * T**0.5
            * (T * 1e-3) ** -0.2 / (1.0 + (T * 1e-6) ** 0.7))


def drHeII(T, nH, Y=0.24, rates="enzo"):
    return (1.24e-13 * ne(T, nH, rates=rates)
            * nHeII(T, nH, Y=Y, rates=rates) * T**-1.5
            * np.exp(-470000.0 / T) * (1.0 + 0.3 * np.exp(-94000.0 / T)))


def gff(T):
    return 1.1 + 0.34 * np.exp(-((5.5 - np.log10(T)) ** 2) / 3.0)


def freefree(T, nH, Y=0.24, rates="enzo"):
    return (1.42e-27 * gff(T) * T**0.5 * ne(T, nH, rates=rates)
            * (nHII(T, nH, rates=rates)
               + nHeII(T, nH, Y=Y, rates=rates)
               + 4 * nHeIII(T, nH, rates=rates)))


def total_cooling(T, nH, rates="enzo"):
    return (ceHI(T, nH, rates=rates) + ceHeII(T, nH, rates=rates)
            + ciHI(T, nH, rates=rates) + ciHeI(T, nH, rates=rates)
            + ciHeII(T, nH, rates=rates) + rHII(T, nH, rates=rates)
            + rHeII(T, nH, rates=rates) + rHeIII(T, nH, rates=rates)
            + drHeII(T, nH, rates=rates) + freefree(T, nH, rates=rates))
