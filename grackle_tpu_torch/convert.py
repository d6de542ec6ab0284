"""Build a port context from host arrays.

:func:`context_from_numpy` takes another package's initialized context
(grackle_tpu's, say) as plain data: parameter values, unit values, rate
tables and Cloudy tables as NumPy arrays.  Both packages then solve on
identical tables, which is how the tests compare them without the port
importing the other package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api import GrackleContext, resolve_device
from .config import PARAMETER_REGISTRY, ChemistryConfig, resolve_config
from .data.cloudy import cloudy_table_from_numpy
from .data.uvb import UVBTable
from .rates.tables import tables_from_arrays
from .units import CodeUnits

_UNIT_FIELDS = ["comoving_coordinates", "density_units", "length_units",
                "time_units", "a_units", "a_value"]


def context_from_numpy(config_params, units, tables: dict,
                       cloudy_primordial: dict, cloudy_metal: dict,
                       device="cuda", dtype=torch.float64,
                       cloudy_data_new: bool = True,
                       uvb=None) -> GrackleContext:
    """A GrackleContext on ``device`` (the CUDA card unless
    ``device="cpu"``) in ``dtype`` from host data.

    config_params: parameter name -> value (every registry name; names the
        registry does not know are ignored).
    units: any object with the six CodeUnits attributes (a CodeUnits of
        either package, say).
    tables: rate-table field name -> array or scalar (rates/tables.py
        ARRAY_FIELDS and SCALAR_FIELDS; extra names are ignored).
    cloudy_primordial, cloudy_metal: loaded Cloudy tables as dicts of
        ``grid_rank``, ``grid_dimension`` and the ``par*``/``cooling``/
        ``heating``/``mmw`` arrays (log10, code units); ``{}`` or
        ``grid_rank`` 0 for an unused table.
    uvb: the UVB table as a dict of ``info`` and float64 arrays
        (data/uvb.UVBTable fields), or None.
    """
    params = {k: v for k, v in dict(config_params).items()
              if k in PARAMETER_REGISTRY}
    cfg = resolve_config(ChemistryConfig(**params))
    if dtype != (torch.float64 if cfg.precision == 64 else torch.float32):
        cfg = dataclasses.replace(
            cfg, precision=64 if dtype == torch.float64 else 32)
    device = resolve_device(device)
    host = {name: (np.asarray(v) if not np.isscalar(v) else v)
            for name, v in tables.items()}
    return GrackleContext(
        config=cfg,
        units=CodeUnits(**{name: getattr(units, name)
                           for name in _UNIT_FIELDS}),
        tables=tables_from_arrays(host, device, dtype),
        cloudy_primordial=cloudy_table_from_numpy(cloudy_primordial,
                                                  device, dtype),
        cloudy_metal=cloudy_table_from_numpy(cloudy_metal, device, dtype),
        uvb=None if uvb is None else UVBTable(**{
            k: (v if k == "info" or v is None
                else np.asarray(v, dtype=np.float64))
            for k, v in uvb.items()}),
        cloudy_data_new=cloudy_data_new,
        device=device,
    )
