"""Temperature / mean molecular weight from the Cloudy MMW table (port of
grackle_tpu/ops/tabulated_temp.py, gather path).

Batched rebuild of the tabulated-mode fixed-point iteration
(grackle: src/clib/calc_temp1d_cloudy_g.F:4-245): T and mu are coupled
through the table mu(n_H, z, T), solved by damped fixed-point iteration
with per-cell convergence masks.
"""

from __future__ import annotations

import math

import torch

from . import interp
from .device_loop import device_while

MU_METAL = 16.0
TI_MAX = 20
#: fixed-point steps per read of "every cell converged"
BLOCK = 4


def tabulated_temperature(cloudy, d, metal, e, rhoH, dom, zr, temstart,
                          gamma, utem, imetal: bool):
    """Iterate T <-> mu(T) against the Cloudy MMW table.

    Returns (tgas, mmw).  cloudy is a CloudyTable with mmw data;
    rank 1 (T), 2 (n_H, T), or 3 (n_H, z, T).
    """
    log_n_h = torch.log10(rhoH * dom)
    rank = cloudy.grid_rank
    zi0 = end_int = None
    if rank == 3:
        zi0, end_int = interp.redshift_index(zr, cloudy.par2,
                                             cloudy.grid_dimension[1])

    def mu_interp(log10tem):
        if rank == 1:
            return interp.interpolate_1d(log10tem, cloudy.par1, cloudy.mmw)
        if rank == 2:
            return interp.interpolate_2d(log_n_h, log10tem, cloudy.par1,
                                         cloudy.par2, cloudy.mmw)
        if rank == 3:
            return interp.interpolate_3dz(
                log_n_h, zr, log10tem, cloudy.par1, cloudy.par2,
                cloudy.par3, cloudy.mmw, zi0, end_int)
        raise ValueError("Maximum mmw data grid rank is 3!")

    return _fixed_point(mu_interp, d, metal, e, temstart, gamma, utem,
                        imetal)


def _fixed_point(mu_interp, d, metal, e, temstart, gamma, utem, imetal):
    """The damped fixed point (calc_temp1d_cloudy_g.F:128-224).  Converged
    cells are frozen by the ``done`` mask, so stopping once every cell has
    converged, read once per BLOCK steps (ops/device_loop.device_while),
    equals the reference's fixed TI_MAX sweep."""
    inv_log10 = 1.0 / math.log(10.0)

    def step(carry, _):
        munew, tgas, done = carry
        muold = munew
        tgas_i = torch.clamp((gamma - 1.0) * e * munew * utem, min=temstart)
        log10tem = torch.log(tgas_i) * inv_log10
        mu_damped = 0.5 * (mu_interp(log10tem) + muold)
        tgas_i = tgas_i * mu_damped / muold
        conv = torch.abs((mu_damped / muold) - 1.0) <= 1.0e-2
        munew = torch.where(done, munew, mu_damped)
        tgas = torch.where(done, tgas, tgas_i)
        return munew, tgas, done | conv

    carry = (torch.ones_like(e), torch.zeros_like(e),
             torch.zeros(e.shape, dtype=torch.bool, device=e.device))
    (munew, tgas, done), _ = device_while(lambda c: ~c[2], step, carry,
                                          TI_MAX, BLOCK)

    # metal correction at convergence (calc_temp1d_cloudy_g.F:214-224);
    # unconverged cells keep the raw mu, as the reference's fall-through
    if imetal:
        muold = munew
        mu_corr = d / ((d - metal) / munew + metal / MU_METAL)
        munew = torch.where(done, mu_corr, munew)
        tgas = torch.where(done, tgas * mu_corr / muold, tgas)
    return tgas, munew
