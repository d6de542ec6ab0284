"""The reference's entry: a configuration's solve on plain PyTorch.

:func:`context` builds what the port's ``initialize`` builds (rate
tables, Cloudy tables, UVB table), from the configuration's parameters,
its code units and the Cloudy groups the benchmark made, with this
package's own code.  :func:`solve` advances a state by ``dt`` on the
monolithic path (``ops/solver.solve_rate_cool``), whatever its width: in
these configurations every cell is independent of the others, and the
port's compacted path gives the monolithic path's answer bit for bit, so
the same answer is due from either.  The scalars reach the body as the
port's stateful call passes them: one block in the solver dtype, read as
0-d views.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import ChemistryConfig, resolve_config
from .data.cloudy import empty_cloudy_table, is_old_style, load_cloudy_table
from .data.uvb import load_uvb_table, update_uvb_rates, uvb_redshift_bounds
from .ops import solver
from .ops.common import (as_dt, block_scalars, make_unit_scalars,
                         photo_rates_from_tables, scalar_block, solver_dtype)
from .rates.tables import build_rate_tables
from .units import CodeUnits


@dataclasses.dataclass
class Context:
    config: object
    units: CodeUnits
    tables: object
    cloudy_primordial: object
    cloudy_metal: object
    uvb: object
    cloudy_data_new: bool
    device: torch.device


def context(parameters: dict, units: dict, groups: dict,
            device) -> Context:
    """The solver's tables for ``parameters`` (grackle parameter names and
    values) in ``units`` (``CodeUnits`` fields), the Cloudy and UVB
    groups in memory, on ``device``."""
    code_units = CodeUnits(**units)
    code_units.validate()
    cfg = resolve_config(ChemistryConfig(**parameters))
    device = torch.device(device)
    dtype = solver_dtype(cfg)
    read_prim = cfg.primordial_chemistry == 0
    read_met = cfg.metal_cooling == 1
    read_uvb = cfg.UVbackground == 1 and cfg.primordial_chemistry > 0
    heating = cfg.UVbackground == 1

    def cloudy(name, read, mmw):
        if not read:
            return empty_cloudy_table()
        return load_cloudy_table(groups, name, code_units,
                                 read_heating=heating, read_mmw=mmw,
                                 device=device, dtype=dtype)

    uvb = None
    if read_uvb:
        uvb = load_uvb_table(groups, cfg)
        updates = uvb_redshift_bounds(cfg, uvb)
        if updates:
            cfg = dataclasses.replace(cfg, **updates)
    return Context(
        config=cfg, units=code_units,
        tables=build_rate_tables(cfg, code_units, device=device,
                                 dtype=dtype),
        cloudy_primordial=cloudy("Primordial", read_prim, True),
        cloudy_metal=cloudy("Metals", read_met, False),
        uvb=uvb,
        cloudy_data_new=not ((read_prim or read_met)
                             and is_old_style(groups)),
        device=device)


def at_a_value(ctx: Context, a_value: float) -> Context:
    """``ctx`` with its units at expansion factor ``a_value``."""
    return dataclasses.replace(
        ctx, units=dataclasses.replace(ctx.units, a_value=a_value))


def solve(ctx: Context, fields: dict, dt: float) -> dict:
    """The state ``fields`` (host arrays, code units) advanced by ``dt``:
    a dict of host float64 arrays, one for each field given."""
    cfg = ctx.config
    dtype = solver_dtype(cfg)
    f = {key: torch.as_tensor(np.asarray(val)).to(device=ctx.device,
                                                  dtype=dtype)
         for key, val in fields.items()}
    us = make_unit_scalars(cfg, ctx.tables, ctx.units)
    if cfg.UVbackground == 1 and ctx.uvb is not None:
        pr = update_uvb_rates(cfg, ctx.uvb, ctx.units)
    else:
        pr = photo_rates_from_tables(ctx.tables)
    us_t, pr_t, _ = block_scalars(
        scalar_block(cfg, ctx.device, us, pr, ctx.units))
    result = solver.solve_rate_cool(
        cfg, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal, pr_t,
        us_t, f, as_dt(dt, f["density"]), imetal="metal" in f,
        cloudy_data_new=ctx.cloudy_data_new, l_h2shield_field=None,
        comoving=bool(ctx.units.comoving_coordinates))
    return {key: result.fields[key].to(torch.float64).cpu().numpy()
            for key in fields}
