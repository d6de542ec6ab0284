"""Cloudy table cooling/heating contribution (port of
grackle_tpu/ops/cloudy_cool.py, gather path).

Batched rebuild of the new-style (rank 1-3) Cloudy interpolation kernel
(grackle: src/clib/cool1d_cloudy_g.F:4-261): the per-cell scalar
interpolation calls become gathers over the whole cell axis.  Legacy 4/5-D
tables (cool1d_cloudy_old_tables_g.F) are not ported yet.
"""

from __future__ import annotations

import math

import torch

from . import interp


def cloudy_cooling(
    cloudy,
    logtem,
    rhoH,
    metallicity,
    dom,
    zr,
    comp2,
    icmbTfloor: int,
    iClHeat: int,
    iZscale: int,
):
    """Return the Cloudy-table edot contribution (code units).

    Mirrors cool1d_cloudy_g.F:98-258: cooling is -10**logLambda, the CMB
    floor is applied as Lambda(T) - Lambda(T_CMB) when
    log10(T) - log10(T_CMB) < 2, heating is added when enabled (and, for
    rank-3 tables, suppressed past the final redshift), the result is
    optionally scaled by metallicity and multiplied by rhoH^2.
    """
    inv_log10 = 1.0 / math.log(10.0)
    log10_tCMB = math.log10(comp2)
    log10tem = logtem * inv_log10
    log_n_h = torch.log10(rhoH * dom)

    rank = cloudy.grid_rank
    zi0 = end_int = None
    if rank == 3:
        d2 = cloudy.grid_dimension[1]
        zi0, end_int = interp.redshift_index(zr, cloudy.par2, d2)

    def table_interp(data, x_temp):
        if rank == 1:
            return interp.interpolate_1d(x_temp, cloudy.par1, data)
        elif rank == 2:
            return interp.interpolate_2d(
                log_n_h, x_temp, cloudy.par1, cloudy.par2, data
            )
        elif rank == 3:
            return interp.interpolate_3dz(
                log_n_h, zr, x_temp,
                cloudy.par1, cloudy.par2, cloudy.par3,
                data, zi0, end_int,
            )
        raise ValueError("Maximum cooling data grid rank is 3!")

    log_cool = table_interp(cloudy.cooling, log10tem)
    edot_met = -torch.pow(10.0, log_cool)

    if icmbTfloor == 1:
        log_cool_cmb = table_interp(
            cloudy.cooling, torch.full_like(log10tem, log10_tCMB)
        )
        edot_met = torch.where(
            (log10tem - log10_tCMB) < 2.0,
            edot_met + torch.pow(10.0, log_cool_cmb),
            edot_met,
        )

    if iClHeat == 1 and cloudy.heating is not None:
        log_heat = table_interp(cloudy.heating, log10tem)
        heat = torch.pow(10.0, log_heat)
        if rank == 3:
            # get_heat is switched off past the final table redshift
            # (cool1d_cloudy_g.F:136-137)
            heat = torch.where(end_int, torch.zeros_like(heat), heat)
        edot_met = edot_met + heat

    if iZscale == 1:
        edot_met = edot_met * metallicity

    return edot_met * rhoH * rhoH
