"""Equilibrium dust temperature solve (port of
grackle_tpu/ops/dust_temp.py).

Batched rebuild of the reference's per-cell Newton-with-numeric-derivative
iteration plus bisection fallback (grackle: src/clib/calc_tdust_1d_g.F:6-471).
Control-flow divergence becomes masked dataflow: all cells advance together
under boolean masks.  Both loops exit early once no cell is active; they
run through ``ops/device_loop.device_while``, which reads the "any cell
active" flag once per block of ``BLOCK`` masked steps (on the host when
eager, on the device inside a CUDA-graph capture).  This is bit-identical
to checking after every step: each update is masked, and steps after a
cell converges leave it untouched.

All quantities here are CGS (the reference keeps the dust solve in CGS;
see rate_functions.c:1328-1336).
"""

from __future__ import annotations

import torch

from ..constants import sigma_sb, tiny
from .common import ipow
from .device_loop import device_while

T_SUBL = 1.5e3  # grain sublimation temperature (calc_tdust_1d_g.F:58)
RADF = 4.0 * sigma_sb
KGR1 = 4.0e-4
KGR200 = 16.0
TOL = 1.0e-5
BI_TOL = 1.0e-3
MINPERT = 1.0e-10
ITMAX = 50
BI_ITMAX = 30
PERT_I = 1.0e-3
#: masked steps per check of the loops' exit condition
BLOCK = 4


def calc_kappa_gr(tdust):
    """Grain Planck mean opacity, Dopcke et al. 2011 normalized to
    Omukai 2000 (calc_tdust_1d_g.F:370-386)."""
    return torch.where(
        tdust < 200.0,
        KGR1 * (tdust * tdust),
        torch.where(
            tdust < T_SUBL,
            torch.full_like(tdust, KGR200),
            torch.clamp(KGR200 * ipow(tdust / 1.5e3, -12), min=tiny),
        ),
    )


def calc_gr_balance(tdust, tgas, kgr, trad4, gasgr, gamma_isrf, nh):
    """Grain heating - cooling balance (calc_tdust_1d_g.F:459-468)."""
    return (
        gamma_isrf
        + RADF * kgr * (trad4 - ipow(tdust, 4))
        + gasgr * nh * (tgas - tdust)
    )


def calc_tdust_1d(tgas, nh, gasgr, gamma_isrf_coef, isrf, itmask, trad,
                  tdust_init=None):
    """Solve for the equilibrium dust temperature of every cell.

    Args:
      tgas: gas temperature [K], shape [N].
      nh: hydrogen number density [cm^-3].
      gasgr: gas/grain heat transfer rate (CGS, already scaled by fgr).
      gamma_isrf_coef: scalar ISRF heating coefficient (gamma_isrf rate).
      isrf: per-cell ISRF in Habing units.
      itmask: active-cell mask (bool).
      trad: CMB temperature (0-d tensor of the fields' dtype).
      tdust_init: optional warm start (e.g. the previous subcycle's
        solution).  Newton converges to the same equilibrium root
        (tol 1e-5) from any bracketed start, so this only cuts the
        iteration count.

    Returns dust temperature, shape [N] (calc_tdust_1d_g.F:6-306).
    """
    trad = torch.clamp(trad, min=1.0)
    trad4 = trad * trad * (trad * trad)
    gamma_isrf = isrf * gamma_isrf_coef

    # Initial guess (calc_tdust_1d_g.F:105-130)
    tdust0 = torch.clamp(
        torch.pow(gamma_isrf / RADF / KGR1, 0.17), min=trad
    )
    if tdust_init is not None:
        # reject out-of-bracket warm starts (first call passes zeros)
        ok = (tdust_init > trad) & (tdust_init < T_SUBL)
        tdust0 = torch.where(ok, tdust_init, tdust0)
    pert0 = torch.full_like(tgas, PERT_I)

    sub_mask = tgas > T_SUBL  # straight to bisection
    done_cold = trad >= tgas  # radiative equilibrium with CMB

    nm_mask = itmask & ~done_cold & ~sub_mask
    tdust = torch.where(done_cold, trad, tdust0)

    def newton_body(carry, _):
        tdust, pert, nm_mask, bi_mask = carry
        tdplus = torch.clamp((1.0 + pert) * tdust, min=1.0e-3)
        kgr = calc_kappa_gr(tdust)
        kgrplus = calc_kappa_gr(tdplus)
        sol = calc_gr_balance(tdust, tgas, kgr, trad4, gasgr,
                              gamma_isrf, nh)
        solplus = calc_gr_balance(tdplus, tgas, kgrplus, trad4, gasgr,
                                  gamma_isrf, nh)
        slope = (solplus - sol) / (pert * tdust)
        tdustold = tdust
        tdustnew = tdust - sol / slope
        pertnew = torch.clamp(
            torch.minimum(pert, 0.5 * torch.abs(tdustnew - tdustold)
                          / tdustnew),
            min=MINPERT,
        )
        negative = tdustnew < trad
        converged = torch.abs(sol / solplus) < TOL
        # update only active-Newton lanes
        tdust = torch.where(nm_mask, tdustnew, tdust)
        pert = torch.where(nm_mask, pertnew, pert)
        bi_mask = bi_mask & ~(nm_mask & converged & ~negative)
        nm_mask = nm_mask & ~negative & ~converged
        return tdust, pert, nm_mask, bi_mask

    bi_mask = itmask & ~done_cold
    (tdust, _, _, bi_mask), _ = device_while(
        lambda c: c[2], newton_body, (tdust, pert0, nm_mask, bi_mask),
        ITMAX, BLOCK,
    )

    # Bisection fallback (calc_tdust_1d_g.F:209-261): cells that never
    # converged with Newton, found a sub-CMB solution, or have
    # tgas > T_subl.
    t_low = torch.where(bi_mask, trad, tdust)
    t_high = tgas
    if tdust_init is not None:
        # Warm-started bracket: the equilibrium moves little between
        # subcycles (the 10% dt limiter bounds tgas changes), so a +-5%
        # window around the previous solution usually still brackets the
        # root -- verified by the balance signs (heating>0 below the
        # root, <0 above); cells where it does not keep the full
        # [trad, tgas] bracket.
        lo_c = torch.clamp(0.95 * tdust_init, min=trad)
        hi_c = torch.minimum(t_high, 1.05 * tdust_init)
        s_lo = calc_gr_balance(lo_c, tgas, calc_kappa_gr(lo_c), trad4,
                               gasgr, gamma_isrf, nh)
        s_hi = calc_gr_balance(hi_c, tgas, calc_kappa_gr(hi_c), trad4,
                               gasgr, gamma_isrf, nh)
        good = ((tdust_init > trad) & (hi_c > lo_c)
                & (s_lo > 0.0) & (s_hi < 0.0))
        t_low = torch.where(bi_mask & good, lo_c, t_low)
        t_high = torch.where(bi_mask & good, hi_c, t_high)

    def bi_body(carry, it):
        t_low, t_high, bi_mask = carry
        t_mid = 0.5 * (t_low + t_high)
        # the first step clamps at T_SUBL; inside a capture the step index
        # is a device tensor and the clamp a select
        if isinstance(it, torch.Tensor):
            t_mid = torch.where(it == 0, torch.clamp(t_mid, max=T_SUBL),
                                t_mid)
        elif it == 0:
            t_mid = torch.clamp(t_mid, max=T_SUBL)
        kgr = calc_kappa_gr(t_mid)
        sol = calc_gr_balance(t_mid, tgas, kgr, trad4, gasgr,
                              gamma_isrf, nh)
        go_up = sol > 0.0
        t_low_new = torch.where(bi_mask & go_up, t_mid, t_low)
        t_high_new = torch.where(bi_mask & ~go_up, t_mid, t_high)
        conv = torch.abs(t_high_new - t_low_new) / t_low_new <= BI_TOL
        bi_mask = bi_mask & ~conv
        return t_low_new, t_high_new, bi_mask

    (t_low, _, _), _ = device_while(
        lambda c: c[2], bi_body, (t_low, t_high, bi_mask), BI_ITMAX, BLOCK,
    )

    return torch.where(itmask, t_low, tdust)
