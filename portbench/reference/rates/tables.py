"""Rate-table construction (port of grackle_tpu/rates/tables.py).

Analogue of the reference's rate-table initialization
(grackle: src/clib/initialize_rates.c:213-472).  All ~70 analytic rates are
evaluated on a log-spaced temperature grid once at initialization on the
host (NumPy, float64) and converted to torch tensors of the solver dtype on
the solver device at the end.  Lookups are gathers + linear interpolation
(ops/lookup.py; grackle: src/clib/solve_rate_cool_g.F:1206-1323).

The JAX package's fused-lookup artefacts (the stacked matrices, the h2dust
log-SVD factors and the double-f32 splits) exist only because a TPU cannot
gather inside a device loop; the port gathers, so it builds none of them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cooling_rates as cr
from . import reactions as rx


def _logT_bins(n_bins: int, t_start: float, t_end: float) -> np.ndarray:
    """Log-spaced temperature bin centers
    (grackle: initialize_rates.c:99-104,136-145)."""
    logT_start = np.log(t_start)
    d_logT = (np.log(t_end) - logT_start) / (n_bins - 1)
    return np.exp(logT_start + np.arange(n_bins) * d_logT)


ARRAY_FIELDS = [
    # chemistry rates (kunit)
    "k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8", "k9", "k10",
    "k11", "k12", "k13", "k14", "k15", "k16", "k17", "k18", "k19",
    "k20", "k23",
    # three-body (kunit_3bdy)
    "k21", "k22",
    # deuterium
    "k50", "k51", "k52", "k53", "k54", "k55", "k56",
    # H ionization
    "k57", "k58",
    # H2 formation heating terms
    "n_cr_n", "n_cr_d1", "n_cr_d2",
    # 2-D / multi-coefficient tables
    "k13dd", "h2dust",
    # cooling tables (coolingUnits)
    "ceHI", "ceHeI", "ceHeII", "ciHeIS", "ciHI", "ciHeI", "ciHeII",
    "reHII", "reHeII1", "reHeII2", "reHeIII", "brem",
    "vibh", "hyd01k", "h2k01", "rotl", "roth",
    "GP99LowDensityLimit", "GP99HighDensityLimit",
    "GAHI", "GAH2", "GAHe", "GAHp", "GAel", "H2LTE",
    "HDlte", "HDlow", "cieco",
    "gas_grain", "regr",
]

SCALAR_FIELDS = [
    "comp", "gammah", "gamma_isrf",
    # constant photo-rates (set by the LW background or left zero)
    "k24", "k25", "k26", "k27", "k28", "k29", "k30", "k31",
    "piHI", "piHeI", "piHeII",
    "crsHI", "crsHeI", "crsHeII",
    "comp_xray", "temp_xray",
]

#: Rate tables on the solver device (analogue of chemistry_data_storage,
#: grackle: src/clib/grackle_chemistry_data.h:246-404).  Array fields are
#: torch tensors: [n_bins] for the 1-D tables, [n_bins, 14] for k13dd and
#: [n_bins, n_dust_bins] for h2dust.  Scalar fields are host Python floats.
RateTables = dataclasses.make_dataclass(
    "RateTables",
    [(name, object, dataclasses.field(default=None))
     for name in ARRAY_FIELDS + SCALAR_FIELDS],
    frozen=True,
)

_CHEM_RATE_FNS = {
    "k1": rx.k1_rate, "k2": rx.k2_rate, "k3": rx.k3_rate, "k4": rx.k4_rate,
    "k5": rx.k5_rate, "k6": rx.k6_rate, "k7": rx.k7_rate, "k8": rx.k8_rate,
    "k9": rx.k9_rate, "k10": rx.k10_rate, "k11": rx.k11_rate,
    "k12": rx.k12_rate, "k13": rx.k13_rate, "k14": rx.k14_rate,
    "k15": rx.k15_rate, "k16": rx.k16_rate, "k17": rx.k17_rate,
    "k18": rx.k18_rate, "k19": rx.k19_rate, "k20": rx.k20_rate,
    "k23": rx.k23_rate,
    "k50": rx.k50_rate, "k51": rx.k51_rate, "k52": rx.k52_rate,
    "k53": rx.k53_rate, "k54": rx.k54_rate, "k55": rx.k55_rate,
    "k56": rx.k56_rate, "k57": rx.k57_rate, "k58": rx.k58_rate,
    "n_cr_n": rx.n_cr_n_rate, "n_cr_d1": rx.n_cr_d1_rate,
    "n_cr_d2": rx.n_cr_d2_rate,
}

_COOLING_RATE_FNS = {
    "ceHI": cr.ceHI_rate, "ceHeI": cr.ceHeI_rate, "ceHeII": cr.ceHeII_rate,
    "ciHeIS": cr.ciHeIS_rate, "ciHI": cr.ciHI_rate, "ciHeI": cr.ciHeI_rate,
    "ciHeII": cr.ciHeII_rate,
    "reHII": cr.reHII_rate, "reHeII1": cr.reHeII1_rate,
    "reHeII2": cr.reHeII2_rate, "reHeIII": cr.reHeIII_rate,
    "brem": cr.brem_rate,
    "vibh": cr.vibh_rate, "hyd01k": cr.hyd01k_rate, "h2k01": cr.h2k01_rate,
    "rotl": cr.rotl_rate, "roth": cr.roth_rate,
    "GP99LowDensityLimit": cr.GP99LowDensityLimit_rate,
    "GP99HighDensityLimit": cr.GP99HighDensityLimit_rate,
    "GAHI": cr.GAHI_rate, "GAH2": cr.GAH2_rate, "GAHe": cr.GAHe_rate,
    "GAHp": cr.GAHp_rate, "GAel": cr.GAel_rate, "H2LTE": cr.H2LTE_rate,
    "HDlte": cr.HDlte_rate, "HDlow": cr.HDlow_rate, "cieco": cr.cieco_rate,
    "gas_grain": cr.gasGrain_rate, "regr": cr.regr_rate,
}


def rate_table_arrays(cfg, units) -> dict:
    """Every rate table as a host float64 NumPy array (scalars as Python
    floats), keyed by the RateTables field name."""
    n = cfg.NumberOfTemperatureBins
    T = _logT_bins(n, cfg.TemperatureStart, cfg.TemperatureEnd)
    T_dust = _logT_bins(
        cfg.NumberOfDustTemperatureBins,
        cfg.DustTemperatureStart,
        cfg.DustTemperatureEnd,
    )

    kunit = units.kunit
    kunit_3bdy = units.kunit_3bdy
    coolunit = units.coolunit

    vals = {}
    # Overflow in the unselected branch of a two-sided fit (np.where) is
    # expected and discarded; suppress the warnings.
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        for name, fn in _CHEM_RATE_FNS.items():
            vals[name] = fn(T, kunit, cfg)
        vals["k21"] = rx.k21_rate(T, kunit_3bdy, cfg)
        vals["k22"] = rx.k22_rate(T, kunit_3bdy, cfg)
        vals["k13dd"] = rx.k13dd_rate(T, kunit, cfg)
        # h2dust: shape (n_T, n_Tdust) (initialize_rates.c:182-210)
        vals["h2dust"] = rx.h2dust_rate(
            T[:, None], T_dust[None, :], kunit, cfg
        )
        for name, fn in _COOLING_RATE_FNS.items():
            vals[name] = fn(T, coolunit, cfg)

    vals["comp"] = cr.comp_rate(coolunit, cfg)
    vals["gammah"] = cr.gammah_rate(coolunit, cfg)
    vals["gamma_isrf"] = cr.gamma_isrf_rate(coolunit, cfg)

    # Constant photo-rates default to zero; the LW background sets k31
    # (grackle: update_UVbackground_rates.c:241-243).
    for name in ["k24", "k25", "k26", "k27", "k28", "k29", "k30", "k31",
                 "piHI", "piHeI", "piHeII", "crsHI", "crsHeI", "crsHeII",
                 "comp_xray", "temp_xray"]:
        vals[name] = 0.0
    if cfg.LWbackground_intensity > 0.0:
        vals["k31"] = (1.38e-12 * cfg.LWbackground_intensity
                       * units.time_units)

    out = {name: np.asarray(vals[name], dtype=np.float64)
           for name in ARRAY_FIELDS}
    out.update({name: float(vals[name]) for name in SCALAR_FIELDS})
    return out


def tables_from_arrays(arrays: dict, device, dtype) -> "RateTables":
    """RateTables from host arrays: array fields become ``dtype`` tensors
    on ``device``, scalar fields host Python floats."""
    out = {}
    for name in ARRAY_FIELDS:
        out[name] = torch.tensor(
            np.asarray(arrays[name], dtype=np.float64), dtype=dtype,
            device=device)
    for name in SCALAR_FIELDS:
        out[name] = float(arrays[name])
    return RateTables(**out)


def build_rate_tables(cfg, units, device="cpu",
                      dtype=torch.float64) -> "RateTables":
    """Compute all rate tables for a config + unit system.

    Mirrors initialize_rates (grackle: src/clib/initialize_rates.c:213-472):
    chemistry rates scaled by kUnit (kUnit_3Bdy for 3-body), cooling rates by
    coolingUnits; h2dust is a 2-D (T_gas, T_dust) table; k13dd is the
    14-coefficient Martin+96 table.
    """
    return tables_from_arrays(rate_table_arrays(cfg, units), device, dtype)
