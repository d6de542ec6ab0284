"""Cloudy table cooling/heating contribution (port of
grackle_tpu/ops/cloudy_cool.py, gather path).

Batched rebuild of the new-style (rank 1-3) Cloudy interpolation kernel
(grackle: src/clib/cool1d_cloudy_g.F:4-261) and of the legacy rank 1-5
tables (cool1d_cloudy_old_tables_g.F): the per-cell scalar interpolation
calls become gathers over the whole cell axis.
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

    ``dom``, ``zr`` and ``comp2`` are the call's 0-d unit scalars.
    Mirrors cool1d_cloudy_g.F:98-258: cooling is -10**logLambda, the CMB
    floor is applied as Lambda(T) - Lambda(T_CMB) when
    log10(T) - log10(T_CMB) < 2, heating is added when enabled (and, for
    rank-3 tables, suppressed past the final redshift), the result is
    optionally scaled by metallicity and multiplied by rhoH^2.
    """
    inv_log10 = 1.0 / math.log(10.0)
    log10_tCMB = torch.log10(comp2)
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
            cloudy.cooling, log10_tCMB.expand_as(log10tem)
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


def cloudy_cooling_old_tables(
    cloudy,
    de,
    d,
    logtem,
    rhoH,
    metallicity,
    dom,
    zr,
    comp2,
    icmbTfloor: int,
    iClHeat: int,
    cl_ele_fra: float,
):
    """Legacy Cloudy tables with metallicity/electron-fraction axes
    (grackle: src/clib/cool1d_cloudy_old_tables_g.F:102-330).

    Axis order by rank: 1 (T); 2 (n_H, T); 3 (n_H, logZ, T);
    4 (n_H, logZ, log_e_frac, T); 5 (n_H, logZ, log_e_frac, z, T).
    The final contribution is ``edot_met * rhoH * d`` (cl_e_frac-scaled for
    rank > 3), unlike the new-style ``rhoH**2`` scaling.
    """
    inv_log10 = 1.0 / math.log(10.0)
    log10_tCMB = torch.log10(comp2)
    log10tem = logtem * inv_log10
    log_n_h = torch.log10(rhoH * dom)
    log_Z = torch.log10(metallicity)

    rank = cloudy.grid_rank
    fh = rhoH / d
    # electron fraction relative to total nuclei
    # (cool1d_cloudy_old_tables_g.F:154-166)
    e_frac = 2.0 * de / (d * (1.0 + fh))
    log_e_frac = torch.clamp(torch.log10(e_frac), max=0.0)
    cl_e_frac = e_frac * (
        1.0 + (2.0 * cl_ele_fra * metallicity * fh) / (1.0 + fh)
    )

    def table_interp(data, x_temp):
        if rank == 1:
            return interp.interpolate_1d(x_temp, cloudy.par1, data)
        elif rank == 2:
            return interp.interpolate_2d(
                log_n_h, x_temp, cloudy.par1, cloudy.par2, data
            )
        elif rank == 3:
            return interp.interpolate_3d(
                log_n_h, log_Z, x_temp,
                cloudy.par1, cloudy.par2, cloudy.par3, data,
            )
        elif rank == 4:
            return interp.interpolate_4d(
                log_n_h, log_Z, log_e_frac, x_temp,
                cloudy.par1, cloudy.par2, cloudy.par3, cloudy.par4, data,
            )
        elif rank == 5:
            # the redshift axis at the call's redshift, in every cell
            return interp.interpolate_5d(
                log_n_h, log_Z, log_e_frac, zr.expand_as(x_temp),
                x_temp, cloudy.par1, cloudy.par2, cloudy.par3, cloudy.par4,
                cloudy.par5, data,
            )
        raise ValueError("old-style Cloudy tables must be rank 1-5")

    log_cool = table_interp(cloudy.cooling, log10tem)
    edot_met = -torch.pow(10.0, log_cool)

    if icmbTfloor == 1:
        log_cool_cmb = table_interp(
            cloudy.cooling, log10_tCMB.expand_as(log10tem)
        )
        edot_met = torch.where(
            (log10tem - log10_tCMB) < 2.0,
            edot_met + torch.pow(10.0, log_cool_cmb),
            edot_met,
        )

    if iClHeat == 1 and cloudy.heating is not None:
        edot_met = edot_met + torch.pow(
            10.0, table_interp(cloudy.heating, log10tem))

    if rank > 3:
        edot_met = edot_met * cl_e_frac

    return edot_met * rhoH * d
