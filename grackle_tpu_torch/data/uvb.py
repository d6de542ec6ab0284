"""UV background tables: ingestion and per-call redshift interpolation
(port of grackle_tpu/data/uvb.py).

Rebuild of the reference's UVB machinery:

* loader for ``/UVBRates/*`` (grackle:
  src/clib/initialize_UVbackground_data.c:27-320), from a grackle data
  file through h5py or from the same groups in memory
  (data/synthetic.synthetic_cloudy_groups carries them);
* per-call piecewise log-log interpolation in (1+z) with the tanh ramp
  (grackle: src/clib/update_UVbackground_rates.c:25-289).  This is host
  scalar work, done once per call in double precision, as the reference
  does it in C; the table stays on the host as NumPy arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from ..ops.common import PhotoRates

_UVB_RATE_NAMES = [
    "k24", "k25", "k26", "k27", "k28", "k29", "k30", "k31",
    "piHI", "piHeI", "piHeII", "crsHI", "crsHeI", "crsHeII",
]
_CROSS_SECTIONS = {"crsHI": "hi_avg_crs", "crsHeII": "heii_avg_crs",
                   "crsHeI": "hei_avg_crs"}


@dataclasses.dataclass(frozen=True)
class UVBTable:
    """Analogue of UVBtable (grackle_chemistry_data.h:213-241): the
    redshift grid and the rate histories as float64 NumPy arrays (None
    where the configuration does not read them)."""

    info: str
    z: Any = None
    k24: Any = None
    k25: Any = None
    k26: Any = None
    k27: Any = None
    k28: Any = None
    k29: Any = None
    k30: Any = None
    k31: Any = None
    piHI: Any = None
    piHeI: Any = None
    piHeII: Any = None
    crsHI: Any = None
    crsHeI: Any = None
    crsHeII: Any = None


def _read_uvb_group(filename) -> dict:
    """The ``/UVBRates`` group of a grackle data file as nested dicts."""
    import h5py

    def walk(group):
        return {name: (walk(item) if isinstance(item, h5py.Group)
                       else item[()]) for name, item in group.items()}

    with h5py.File(filename, "r") as f:
        return walk(f["/UVBRates"])


def load_uvb_table(source, cfg) -> UVBTable:
    """Read the UVB rates (initialize_UVbackground_data.c:55-272) from a
    grackle data file path or from in-memory groups holding a
    ``"UVBRates"`` entry of the file's layout.

    The higher-network rates (k27-k31) are read only when
    primordial_chemistry > 1, the cross-sections only when
    self_shielding_method > 0, as the reference reads them.
    """
    group = (source["UVBRates"] if isinstance(source, dict)
             else _read_uvb_group(source))
    info = group.get("Info", "")
    if isinstance(info, (bytes, np.bytes_)):
        info = bytes(info).decode()

    def arr(x):
        return np.asarray(x, dtype=np.float64)

    vals = {"z": arr(group["z"])}
    chem = ["k24", "k25", "k26"]
    if cfg.primordial_chemistry > 1:
        chem += ["k27", "k28", "k29", "k30", "k31"]
    for k in chem:
        vals[k] = arr(group["Chemistry"][k])
    for k in ["piHI", "piHeII", "piHeI"]:
        vals[k] = arr(group["Photoheating"][k])
    if cfg.self_shielding_method > 0:
        for k, name in _CROSS_SECTIONS.items():
            vals[k] = arr(group["CrossSections"][name])
    return UVBTable(info=str(info), **vals)


def uvb_redshift_bounds(cfg, uvb: UVBTable):
    """The default on/off redshifts from the table extent, as pygrackle's
    initialize derives them when the user leaves them unset: on/fullon
    at the table maximum, drop/off at the minimum."""
    zmax = float(uvb.z.max())
    zmin = float(uvb.z.min())
    updates = {}
    if cfg.UVbackground_redshift_on <= -99998.0:
        updates["UVbackground_redshift_on"] = zmax
    if cfg.UVbackground_redshift_fullon <= -99998.0:
        updates["UVbackground_redshift_fullon"] = zmax
    if cfg.UVbackground_redshift_drop <= -99998.0:
        updates["UVbackground_redshift_drop"] = zmin
    if cfg.UVbackground_redshift_off <= -99998.0:
        updates["UVbackground_redshift_off"] = zmin
    return updates


def update_uvb_rates(cfg, uvb: UVBTable, units) -> PhotoRates:
    """The per-call photo rates (update_UVbackground_rates.c:25-289) as
    host floats; the redshift enters through ``units.a_value``."""
    out = {name: 0.0 for name in
           _UVB_RATE_NAMES + ["comp_xray", "temp_xray"]}

    # in tabulated mode the UVB enters only through the Cloudy heating
    # data; the photo rates stay zero (update_UVbackground_rates.c:32-34)
    if cfg.primordial_chemistry == 0:
        return PhotoRates(**out)

    redshift = 1.0 / (units.a_value * units.a_units) - 1.0
    # outside [redshift_off, redshift_on] the reference returns before
    # computing anything, leaving every rate zero
    # (update_UVbackground_rates.c:36-41)
    if not (cfg.UVbackground_redshift_off <= redshift
            <= cfg.UVbackground_redshift_on):
        return PhotoRates(**out)

    # tanh ramp (update_UVbackground_rates.c:47-63)
    if redshift > cfg.UVbackground_redshift_fullon:
        ramp = 0.5 - 0.5 * math.tanh(
            15.0 * (redshift - 0.5 * (cfg.UVbackground_redshift_on
                                      + cfg.UVbackground_redshift_fullon)))
    elif redshift < cfg.UVbackground_redshift_drop:
        ramp = 0.5 - 0.5 * math.tanh(
            15.0 * (0.5 * (cfg.UVbackground_redshift_drop
                           + cfg.UVbackground_redshift_off) - redshift))
    else:
        ramp = 1.0

    # redshift bracket (update_UVbackground_rates.c:69-78): first index
    # with zvec[index] >= redshift, clipped to [1, Nz-1]
    zvec = uvb.z
    idx = int(np.clip(np.searchsorted(zvec, redshift, side="left"), 1,
                      zvec.shape[0] - 1))
    zvec_grad = math.log((1.0 + zvec[idx]) / (1.0 + zvec[idx - 1]))
    redshift_grad = math.log((1.0 + redshift) / (1.0 + zvec[idx - 1]))

    def zinterp(table):
        # piecewise power law in (1+z) (update_UVbackground_rates.c:80-96)
        lo, hi = float(table[idx - 1]), float(table[idx])
        slope = math.log(hi / lo) / zvec_grad
        return math.exp(redshift_grad * slope + math.log(lo))

    names = ["k24", "k25", "k26", "piHI", "piHeII", "piHeI"]
    if cfg.primordial_chemistry > 1:
        names += ["k27", "k28", "k29", "k30", "k31"]
    if cfg.self_shielding_method > 0:
        names += ["crsHI", "crsHeI", "crsHeII"]
    for name in names:
        out[name] = zinterp(getattr(uvb, name))

    # unit conversion (update_UVbackground_rates.c:191-218): photo rates
    # to 1/code-time; heating rates from eV/s to code cooling units
    tbase1 = units.time_units
    xbase1 = units.co_length_units / (units.a_value * units.a_units)
    dbase1 = units.co_density_units * (units.a_value * units.a_units) ** 3
    ev2erg = 1.60217653e-12
    mh_uvb = 1.67262171e-24
    cooling_units = (
        units.a_units**5 * xbase1**2 * mh_uvb**2
    ) / (tbase1**3 * dbase1) / ev2erg

    for k in ["k24", "k25", "k26", "k27", "k28", "k29", "k30", "k31"]:
        out[k] = out[k] * units.time_units * ramp
    for k in ["piHI", "piHeII", "piHeI"]:
        out[k] = out[k] / cooling_units * ramp

    # LW background override (update_UVbackground_rates.c:241-256)
    if cfg.LWbackground_intensity > 0.0:
        out["k31"] = 1.38e-12 * cfg.LWbackground_intensity * units.time_units
    if cfg.LWbackground_sawtooth_suppression:
        out["k31"] = out["k31"] * (0.1 + 0.9 * ramp)

    # Compton X-ray heating (update_UVbackground_rates.c:260-285)
    if cfg.Compton_xray_heating:
        z_cut = 5.0
        zp1 = 1.0 + redshift
        out["comp_xray"] = (
            4.15e-13 * 3.0e10
            * (31.8 * zp1**0.3333 / 511.0)
            * (6.3e-5 * 1.6e-12)
            * zp1**4
            * math.exp(-((redshift / z_cut) ** 2))
            / cooling_units
        )
        out["temp_xray"] = (
            31.8e3 * zp1**0.3333 * 1.6e-12
            / (4.0 * 1.38e-16)
            * 6.3e-5 * zp1**4
            * math.exp(-((redshift / z_cut) ** 2))
            / (0.256 * zp1)
        )
    return PhotoRates(**{k: float(v) for k, v in out.items()})
