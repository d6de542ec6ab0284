"""Cloudy cooling-table ingestion (port of grackle_tpu/data/cloudy.py).

Analogue of the reference's HDF5 table loader
(grackle: src/clib/initialize_cloudy_data.c:28-316).  Reads
``/CoolingRates/<group>/{Cooling,Heating,MMW}`` with ``Rank``/``Dimension``/
``Parameter1..N``/``Temperature`` attributes, log10s the data, shifts by
log10(CoolUnit) into code units, and moves dense tensors to the solver
device.

A table source is the content of a grackle data file in memory (this
copy reads no file): a dict
mapping each group name to ``{"Cooling": array, "Heating": array, "MMW":
array, "Rank": int, "Dimension": tuple, "Parameter1": array, ...,
"Temperature": array}`` with a top-level ``"old_style"`` key where the file has that attribute
(portbench/yardstick/synthetic.py builds one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch


SMALL_LOG_VALUE = -99.0
CLOUDY_MAX_DIMENSION = 5


@dataclasses.dataclass(frozen=True)
class CloudyTable:
    """Cloudy data on the solver device (analogue of cloudy_data,
    grackle: src/clib/grackle_chemistry_data.h:183-207).

    grid_rank 0 means "not in use".  Parameter axes: the last axis is always
    log10(T); for rank 2 the first is log10(n_H); for rank 3 the middle is
    redshift.  Data tensors are C order with parameter 1 slowest, matching
    the flattened layout the reference indexes (interpolators_g.F:83,150).
    """

    grid_rank: int
    grid_dimension: Tuple[int, ...]
    par1: Any = None
    par2: Any = None
    par3: Any = None
    par4: Any = None
    par5: Any = None
    cooling: Any = None
    heating: Any = None
    mmw: Any = None


def empty_cloudy_table() -> CloudyTable:
    return CloudyTable(grid_rank=0, grid_dimension=())


def _cool_unit(units) -> float:
    """CoolUnit as computed by the loader; NOTE the reference uses the
    truncated mh = 1.67e-24 here (initialize_cloudy_data.c:79-81), unlike
    the rest of the library.  Reproduced exactly for parity."""
    mh = 1.67e-24
    tbase1 = units.time_units
    xbase1 = units.co_length_units / (units.a_value * units.a_units)
    dbase1 = units.co_density_units * (units.a_value * units.a_units) ** 3
    return (units.a_units**5 * xbase1**2 * mh**2) / (tbase1**3 * dbase1)


def _read_group(filename, group_name, read_heating, read_mmw) -> dict:
    """This copy reads tables from memory only."""
    raise NotImplementedError("the reference takes its tables in memory")


def _to_tensor(arr, device, dtype):
    return torch.tensor(np.asarray(arr, dtype=np.float64), dtype=dtype,
                        device=device)


def load_cloudy_table(
    source,
    group_name: str,
    units,
    read_heating: bool,
    read_mmw: bool,
    device="cpu",
    dtype=torch.float64,
) -> CloudyTable:
    """Read one Cloudy group ("Primordial" or "Metals") from a grackle data
    file path or from its in-memory form (initialize_cloudy_data.c:83-315)."""
    if isinstance(source, dict):
        group = source[group_name]
    else:
        group = _read_group(source, group_name, read_heating, read_mmw)

    rank = int(np.asarray(group["Rank"]).item())
    dims = tuple(int(x) for x in np.asarray(group["Dimension"]).ravel())
    if rank > CLOUDY_MAX_DIMENSION:
        raise ValueError(
            f"rank of Cloudy cooling data must be <= {CLOUDY_MAX_DIMENSION}"
        )
    pars = []
    for q in range(rank):
        if q < rank - 1:
            p = np.asarray(group[f"Parameter{q + 1}"], dtype=np.float64)
        else:
            # temperature axis converted to log10
            # (initialize_cloudy_data.c:187-190)
            p = np.log10(np.asarray(group["Temperature"], dtype=np.float64))
        pars.append(p)

    log_coolunit = np.log10(_cool_unit(units))

    def to_log_code_units(arr):
        arr = np.asarray(arr, dtype=np.float64).reshape(dims)
        out = np.where(
            arr > 0, np.log10(np.where(arr > 0, arr, 1.0)),
            SMALL_LOG_VALUE,
        )
        return out - log_coolunit

    cooling = to_log_code_units(group["Cooling"])
    heating = to_log_code_units(group["Heating"]) if read_heating else None
    mmw = None
    if read_mmw:
        mmw = np.asarray(group["MMW"], dtype=np.float64).reshape(dims)

    kw = {f"par{i + 1}": _to_tensor(p, device, dtype)
          for i, p in enumerate(pars)}
    return CloudyTable(
        grid_rank=rank,
        grid_dimension=dims,
        cooling=_to_tensor(cooling, device, dtype),
        heating=None if heating is None else _to_tensor(heating, device,
                                                        dtype),
        mmw=None if mmw is None else _to_tensor(mmw, device, dtype),
        **kw,
    )


def cloudy_table_from_numpy(arrays: dict, device="cpu",
                            dtype=torch.float64) -> CloudyTable:
    """A CloudyTable from already-converted host arrays (log10, code units):
    ``grid_rank``, ``grid_dimension`` and any of ``par1..par5``,
    ``cooling``, ``heating``, ``mmw``.  This is how another package's
    loaded table crosses over (convert.py)."""
    rank = int(arrays.get("grid_rank", 0))
    if rank == 0:
        return empty_cloudy_table()
    kw = {}
    for name in ["par1", "par2", "par3", "par4", "par5",
                 "cooling", "heating", "mmw"]:
        val = arrays.get(name)
        if val is not None:
            kw[name] = _to_tensor(val, device, dtype)
    return CloudyTable(
        grid_rank=rank,
        grid_dimension=tuple(int(x) for x in arrays["grid_dimension"]),
        **kw,
    )


def is_old_style(source) -> bool:
    """Detect legacy 4/5-D tables via the ``old_style`` key of the
    in-memory groups (initialize_cloudy_data.c:92-96)."""
    return "old_style" in source
