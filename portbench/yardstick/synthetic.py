"""Synthetic grackle-format Cloudy and UVB tables in memory: the
benchmark's copy of grackle_tpu_torch/data/synthetic.py (commit
4d9fd799c427), its file writers left out.

``synthetic_cloudy_groups`` returns the tables in the layout the port's
``data/cloudy.load_cloudy_table`` and ``data/uvb.load_uvb_table`` read,
and portbench/reference's copies of them.  The benchmark makes them once
a run and hands the same groups to the program and to the reference.

The primordial cooling/MMW tables come from the analytic
collisional-ionization-equilibrium model (primordial_equilibrium.py);
metal cooling is a smooth Lambda_Z(T) bump; the UVB rates follow an
HM2012-like redshift history.
"""

from __future__ import annotations

import numpy as np

from . import primordial_equilibrium as peq


def _primordial_tables(log_nh, zgrid, log_T):
    """Λ/n_H^2 [erg cm^3 / s], heating, and mu on the (n_H, z, T) grid."""
    nh = 10.0**log_nh
    T = 10.0**log_T
    n_nh, n_z, n_T = len(log_nh), len(zgrid), len(log_T)
    cool = np.zeros((n_nh, n_z, n_T))
    heat = np.zeros((n_nh, n_z, n_T))
    mmw = np.zeros((n_nh, n_z, n_T))
    Y = 0.24
    # neutral-gas limits where the equilibrium formulas underflow (low T)
    y_he = Y / (4 - 4 * Y)  # n_He / n_H
    mu_neutral = (1.0 + 4.0 * y_he) / (1.0 + y_he)
    for i, nhi in enumerate(nh):
        with np.errstate(all="ignore"):
            lam = peq.total_cooling(T, nhi) / nhi**2  # erg cm^3/s
            # equilibrium mean molecular weight
            ntot = (peq.nHI(T, nhi) + peq.nHII(T, nhi)
                    + peq.nHeI(T, nhi, Y=Y) + peq.nHeII(T, nhi, Y=Y)
                    + peq.nHeIII(T, nhi, Y=Y) + peq.ne(T, nhi, Y=Y))
            rho_over_mh = nhi + 4.0 * (
                peq.nHeI(T, nhi, Y=Y) + peq.nHeII(T, nhi, Y=Y)
                + peq.nHeIII(T, nhi, Y=Y)
            )
            mu = rho_over_mh / ntot
        mu = np.where(np.isfinite(mu), mu, mu_neutral)
        mu = np.clip(mu, 0.5, mu_neutral)
        lam = np.where(np.isfinite(lam) & (lam > 0), lam, 1.0e-40)
        # keep a tiny low-T floor so log10 is finite
        lam = np.maximum(lam, 1.0e-40)
        for j, z in enumerate(zgrid):
            # weak redshift dependence stands in for the UVB's effect
            fz = 1.0 + 0.05 * np.log1p(z)
            cool[i, j, :] = lam * fz
            heat[i, j, :] = 1.0e-26 * np.exp(-T / 1.0e5) / (1.0 + nhi) \
                * fz
            mmw[i, j, :] = mu
    return cool, heat, mmw


def _metal_tables(log_nh, zgrid, log_T):
    """Smooth metal-cooling bump peaking near 2e5 K (solar Z)."""
    nh = 10.0**log_nh
    T = 10.0**log_T
    n_nh, n_z, n_T = len(log_nh), len(zgrid), len(log_T)
    cool = np.zeros((n_nh, n_z, n_T))
    heat = np.zeros((n_nh, n_z, n_T))
    lam_z = (
        3.0e-22 * np.exp(-0.5 * ((np.log10(T) - 5.3) / 0.7) ** 2)
        + 1.0e-23 * (T / 1.0e7) ** 0.5 * (T > 1.0e6)
        + 1.0e-26 * (T / 1.0e4) ** 2 / (1.0 + (T / 1.0e4) ** 2)
    )
    for i, nhi in enumerate(nh):
        for j, z in enumerate(zgrid):
            fz = 1.0 / (1.0 + 0.1 * z)
            cool[i, j, :] = lam_z * fz + 1.0e-30
            heat[i, j, :] = 5.0e-27 * np.exp(-T / 2.0e4) * fz + 1.0e-32
    return cool, heat


def _group(cool, heat, mmw, log_nh, zgrid, log_T):
    """One ``CoolingRates/<group>`` as the in-memory schema: the datasets
    plus the attributes the file writer attaches to each of them."""
    group = {
        "Rank": np.int64(3),
        "Dimension": np.array(cool.shape, dtype=np.int64),
        "Parameter1": np.asarray(log_nh, dtype=np.float64),
        "Parameter2": np.asarray(zgrid, dtype=np.float64),
        "Temperature": 10.0 ** np.asarray(log_T, dtype=np.float64),
        "Cooling": cool,
        "Heating": heat,
    }
    if mmw is not None:
        group["MMW"] = mmw
    return group


def _uvb_group(z_max):
    """``/UVBRates`` of the synthetic data file: an HM2012-like history
    peaking near z ~ 2, as nested dicts of the file's groups."""
    zu = np.linspace(0.0, z_max, 60)
    shape = np.exp(-((zu - 2.0) ** 2) / 8.0) + 0.05
    return {
        "Info": "synthetic UVB for grackle_tpu tests",
        "z": zu,
        # 1/s
        "Chemistry": {
            "k24": 2.4e-13 * shape, "k25": 1.2e-14 * shape,
            "k26": 1.3e-13 * shape, "k27": 5.0e-10 * shape,
            "k28": 1.0e-10 * shape, "k29": 8.0e-14 * shape,
            "k30": 2.0e-13 * shape, "k31": 1.0e-12 * shape,
        },
        # eV/s per atom (update_UVbackground_rates.c:198-199); roughly
        # <E> ~ 4 eV per ionization
        "Photoheating": {
            "piHI": 4.0 * 2.4e-13 * shape,
            "piHeI": 4.5 * 1.3e-13 * shape,
            "piHeII": 7.0 * 1.2e-14 * shape,
        },
        "CrossSections": {
            "hi_avg_crs": 2.49e-18 * (1.0 + 0 * zu),
            "hei_avg_crs": 4.4e-18 * (1.0 + 0 * zu),
            "heii_avg_crs": 1.6e-18 * (1.0 + 0 * zu),
        },
    }


def synthetic_cloudy_groups(
    n_density=25,
    n_redshift=10,
    n_temperature=121,
    z_max=10.0,
):
    """The content of grackle_tpu's ``make_synthetic_data_file`` (same
    arguments, same arrays): ``{"Primordial": ..., "Metals": ...}`` for
    ``load_cloudy_table`` and ``"UVBRates"`` for ``load_uvb_table``."""
    log_nh = np.linspace(-10.0, 4.0, n_density)
    zgrid = np.linspace(0.0, z_max, n_redshift)
    log_T = np.linspace(1.0, 9.0, n_temperature)

    p_cool, p_heat, p_mmw = _primordial_tables(log_nh, zgrid, log_T)
    m_cool, m_heat = _metal_tables(log_nh, zgrid, log_T)
    return {
        "Primordial": _group(p_cool, p_heat, p_mmw, log_nh, zgrid, log_T),
        "Metals": _group(m_cool, m_heat, None, log_nh, zgrid, log_T),
        "UVBRates": _uvb_group(z_max),
    }


def synthetic_old_style_groups(rank=4):
    """The content of grackle_tpu's ``make_synthetic_old_style_file`` (same
    arrays): a legacy ('old_style') metal-cooling source with a rank-4
    (n_H, logZ, e_frac, T) or rank-5 (+z) Metals table
    (grackle: src/clib/cool1d_cloudy_old_tables_g.F,
    initialize_cloudy_data.c:92-96), carrying the file's top-level
    ``"old_style"`` attribute as a key."""
    log_nh = np.linspace(-6.0, 4.0, 11)
    log_z = np.linspace(-4.0, 0.5, 7)
    e_frac = np.linspace(-6.0, 0.0, 5)  # log10 electron fraction
    zgrid = np.linspace(0.0, 8.0, 5)
    log_T = np.linspace(1.0, 9.0, 81)
    T = 10.0**log_T

    # amplitude exaggerated so tests see a clear metallicity response
    lam = 2.0e-21 * np.exp(-0.5 * ((np.log10(T) - 5.3) / 0.8) ** 2) \
        + 1.0e-24
    # old-style tables carry metallicity as a table axis (no external
    # scaling), so the synthetic cooling grows with log_Z
    if rank not in (4, 5):
        raise ValueError("synthetic old-style tables are rank 4 or 5")
    zscale = 10.0 ** log_z
    pars = [log_nh, log_z, e_frac] + ([zgrid] if rank == 5 else [])
    dims = tuple(len(p) for p in pars) + (len(log_T),)
    zscale = zscale.reshape((1, -1) + (1,) * (rank - 2))  # along axis 1
    cool = (lam * zscale + 1.0e-27) * np.ones(dims)
    heat = np.broadcast_to(1e-27 * np.exp(-T / 3e4) + 1e-32, dims).copy()
    group = {
        "Rank": np.int64(rank),
        "Dimension": np.array(dims, dtype=np.int64),
        "Temperature": 10.0 ** np.asarray(log_T, dtype=np.float64),
        "Cooling": cool,
        "Heating": heat,
    }
    for i, p in enumerate(pars):
        group[f"Parameter{i + 1}"] = np.asarray(p, dtype=np.float64)
    return {"old_style": np.int64(1), "Metals": group}
