"""Python side of the C ABI shim (port of grackle_tpu/cshim_bridge.py).

The reference is consumed by C/C++/Fortran hydro codes through the
``grackle.h`` C API (grackle: src/clib/grackle.h:14-187).  The port's
equivalent is ``libgrackle_tpu.so`` built by
:mod:`grackle_tpu_torch.cshim_build` from ``csrc/grackle_tpu_shim.cpp``: a
C++ library that embeds CPython and dispatches into this bridge.  Field
arrays cross the boundary zero-copy: the bridge wraps the caller's
pointers with NumPy, solves on the device, copies the results to the host
and writes them back in place, exactly as the reference kernels mutate the
caller's arrays.

The device is ``GRACKLE_TPU_TORCH_DEVICE`` (default ``cuda``); on a host
without a card initialization raises, so the C call returns failure: it
never falls back to the CPU.  A host's solves run in its own process:
with ``GRACKLE_TPU_TORCH_LAUNCH_LOG`` naming a file, each solve writes
there the network kernel's launches of the process so far, those of the
replayed graphs included, counted on the device (graph_cache.py: a
context's second solve of a width captures, later ones replay).

Handles: every initialized context gets an integer handle (the analogue of
the reference's ``chemistry_data_storage``); the global-API variants use
handle 0 implicitly.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict

import numpy as np
import torch

from .api import ChemistryData

_contexts: Dict[int, ChemistryData] = {}
_next_handle = [1]

_FIELD_NAMES = [
    "density", "internal_energy", "x_velocity", "y_velocity",
    "z_velocity", "e_density", "HI_density", "HII_density",
    "HM_density", "HeI_density", "HeII_density", "HeIII_density",
    "H2I_density", "H2II_density", "DI_density", "DII_density",
    "HDI_density", "metal_density", "dust_density",
    "volumetric_heating_rate", "specific_heating_rate",
    "RT_heating_rate", "RT_HI_ionization_rate",
    "RT_HeI_ionization_rate", "RT_HeII_ionization_rate",
    "RT_H2_dissociation_rate", "H2_self_shielding_length",
    "H2_custom_shielding_factor", "isrf_habing",
]

# C field name -> solver field name
_NAME_MAP = {
    "density": "density",
    "internal_energy": "energy",
    "e_density": "de",
    "HI_density": "HI",
    "HII_density": "HII",
    "HM_density": "HM",
    "HeI_density": "HeI",
    "HeII_density": "HeII",
    "HeIII_density": "HeIII",
    "H2I_density": "H2I",
    "H2II_density": "H2II",
    "DI_density": "DI",
    "DII_density": "DII",
    "HDI_density": "HDI",
    "metal_density": "metal",
    "dust_density": "dust",
    "volumetric_heating_rate": "volumetric_heating_rate",
    "specific_heating_rate": "specific_heating_rate",
    "RT_heating_rate": "RT_heating_rate",
    "RT_HI_ionization_rate": "RT_HI_ionization_rate",
    "RT_HeI_ionization_rate": "RT_HeI_ionization_rate",
    "RT_HeII_ionization_rate": "RT_HeII_ionization_rate",
    "RT_H2_dissociation_rate": "RT_H2_dissociation_rate",
    "H2_self_shielding_length": "H2_self_shielding_length",
    "H2_custom_shielding_factor": "H2_custom_shielding_factor",
    "isrf_habing": "isrf_habing",
}


def _host(val) -> np.ndarray:
    """A result (tensor on any device, or array) as a host array."""
    if isinstance(val, torch.Tensor):
        return val.cpu().numpy()
    return np.asarray(val)


def _wrap(addr: int, n: int, itemsize: int) -> np.ndarray:
    """Zero-copy NumPy view of a caller-owned gr_float array."""
    ctype = ctypes.c_double if itemsize == 8 else ctypes.c_float
    ptr = ctypes.cast(addr, ctypes.POINTER(ctype))
    return np.ctypeslib.as_array(ptr, shape=(n,))


def initialize_context(params: dict, units: dict) -> int:
    """set_default_chemistry_parameters + initialize_chemistry_data."""
    cd = ChemistryData()
    for key, val in params.items():
        if isinstance(val, bytes):
            val = val.decode()
        setattr(cd, key, val)
    for key, val in units.items():
        setattr(cd, key, val)
    device = os.environ.get("GRACKLE_TPU_TORCH_DEVICE", "cuda")
    if cd.initialize(device=device) != 1:
        return -1
    handle = _next_handle[0]
    _next_handle[0] += 1
    _contexts[handle] = cd
    return handle


def free_context(handle: int) -> int:
    _contexts.pop(handle, None)
    return 1


def _update_units(cd: ChemistryData, units: dict):
    for key, val in units.items():
        setattr(cd, key, val)


def _active_slice(grid_rank, grid_dimension, grid_start, grid_end):
    """Active-region selection honoring ghost zones (the analogue of the
    reference's is/ie loop bounds, index_helper.h:24-66).

    Returns (total_size, flat boolean selection or None for full grids).
    """
    dims = list(grid_dimension)
    total = int(np.prod(dims))
    start = list(grid_start)
    end = list(grid_end)
    full = all(s == 0 and e == d - 1
               for s, e, d in zip(start, end, dims))
    if full:
        return total, None
    mask = np.zeros(dims[::-1], dtype=bool)  # C order: k, j, i
    sl = tuple(slice(s, e + 1) for s, e in zip(start[::-1], end[::-1]))
    mask[sl] = True
    return total, mask.reshape(-1)


def _gather_fields(field_ptrs: dict, n: int, itemsize: int, sel):
    fields = {}
    views = {}
    for cname, addr in field_ptrs.items():
        if addr == 0 or cname not in _NAME_MAP:
            continue
        view = _wrap(addr, n, itemsize)
        views[cname] = view
        fields[_NAME_MAP[cname]] = (
            view if sel is None else view[sel]
        )
    return fields, views


def solve_chemistry(handle: int, units: dict, grid: dict,
                    field_ptrs: dict, dt: float, itemsize: int) -> int:
    """local_solve_chemistry (solve_chemistry.c:91-377)."""
    cd = _contexts.get(handle)
    if cd is None:
        return 0
    _update_units(cd, units)
    n, sel = _active_slice(grid["grid_rank"], grid["grid_dimension"],
                           grid["grid_start"], grid["grid_end"])
    fields, views = _gather_fields(field_ptrs, n, itemsize, sel)
    grid_shape = None
    l_h2 = None
    if cd.H2_self_shielding == 1:
        # Sobolev stencil on the FULL grid (ghost zones included), then
        # slice to the active cells — boundary active cells must read
        # real ghost-zone neighbor densities
        # (solve_rate_cool_g.F:1420-1434).
        dims = list(grid["grid_dimension"])
        if sel is None:
            grid_shape = tuple(dims[::-1])  # C order: (k, j, i)
        else:
            from .api import sobolev_shield_length
            from .ops.common import make_unit_scalars

            ctx = cd._require_context()  # refreshes units
            us = make_unit_scalars(ctx.config, ctx.tables, ctx.units,
                                   grid.get("grid_dx", 0.0))
            d_full = torch.as_tensor(
                views["density"].reshape(dims[::-1])).to(ctx.device)
            l_h2 = _host(sobolev_shield_length(
                d_full, us.xbase1, us.dx_cgs
            )).reshape(-1)[sel]
    log = os.environ.get("GRACKLE_TPU_TORCH_LAUNCH_LOG")
    if log:
        from .ops.network_kernel import library

        library.count_replays(cd._require_context().device)
    new_f, _ = cd.solve_chemistry(
        fields, dt, grid_dx=grid.get("grid_dx", 0.0),
        grid_shape=grid_shape, l_h2shield=l_h2,
    )
    # write evolved species + energy back into the caller's memory
    inv_map = {v: k for k, v in _NAME_MAP.items()}
    for name, val in new_f.items():
        cname = inv_map.get(name)
        if cname is None or cname not in views:
            continue
        out = _host(val).astype(views[cname].dtype, copy=False)
        if sel is None:
            views[cname][:] = out
        else:
            views[cname][sel] = out
    if log:
        from .ops.network_kernel import library

        with open(log, "w") as fh:
            fh.write(str(library.executed()))
    return 1


def _calculate(handle: int, units: dict, grid: dict, field_ptrs: dict,
               which: str, out_addr: int, itemsize: int) -> int:
    cd = _contexts.get(handle)
    if cd is None:
        return 0
    _update_units(cd, units)
    n, sel = _active_slice(grid["grid_rank"], grid["grid_dimension"],
                           grid["grid_start"], grid["grid_end"])
    fields, _ = _gather_fields(field_ptrs, n, itemsize, sel)
    out_view = _wrap(out_addr, n, itemsize)
    result = getattr(cd, f"calculate_{which}")(fields)
    out = _host(result).astype(out_view.dtype, copy=False)
    if sel is None:
        out_view[:] = out
    else:
        out_view[sel] = out
    return 1


def calculate_cooling_time(handle, units, grid, field_ptrs, out_addr,
                           itemsize):
    return _calculate(handle, units, grid, field_ptrs, "cooling_time",
                      out_addr, itemsize)


def calculate_temperature(handle, units, grid, field_ptrs, out_addr,
                          itemsize):
    return _calculate(handle, units, grid, field_ptrs, "temperature",
                      out_addr, itemsize)


def calculate_pressure(handle, units, grid, field_ptrs, out_addr,
                       itemsize):
    return _calculate(handle, units, grid, field_ptrs, "pressure",
                      out_addr, itemsize)


def calculate_gamma(handle, units, grid, field_ptrs, out_addr, itemsize):
    return _calculate(handle, units, grid, field_ptrs, "gamma",
                      out_addr, itemsize)


def calculate_dust_temperature(handle, units, grid, field_ptrs, out_addr,
                               itemsize):
    return _calculate(handle, units, grid, field_ptrs,
                      "dust_temperature", out_addr, itemsize)


def get_parameter(handle: int, name: str):
    cd = _contexts.get(handle)
    if cd is None:
        return None
    return cd[name]
