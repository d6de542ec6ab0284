"""Exact-integration radiative cooling for tabulated mode (port of
grackle_tpu/ops/exact_cool.py).

An opt-in alternative (``exact_cooling = 1``) to the subcycled energy
integration for ``primordial_chemistry = 0``: instead of stepping
``de/dt = edot(e)/d`` with the 10%-change limiter (up to hundreds of
subcycles), the temporal evolution function of Townsend (2009, ApJS 181,
391) is evaluated on the Cloudy temperature grid and the step is solved
in closed form.  The piecewise power-law representation of the cooling
curve between table nodes makes the integral of ``d * de / (-edot(e))``
analytic per segment, so the whole update is one vectorized pass:
per-cell node tables, prefix sums, a segment locate, and an analytic
inversion.  No subcycle loop, no host reads and no kernel launch of the
network region.

Scope (validated at initialize): tabulated mode without external heating
(UVbackground, RT, user heating arrays, photoelectric heating, dust all
off).  Compton exchange with the CMB is included in the cooling curve.
Cells with net heating at their current state (T below the equilibrium
point) are held unchanged for the step.

Memory: every (N, K) node array (K temperature nodes, 121 for the
synthetic tables) holds N*K values; each is deleted once dead, so the
peak is a few of them at a time.

This capability has no analogue in the reference (grackle integrates
tabulated cooling with the same subcycled stepper as the chemistry
networks; src/clib/solve_rate_cool_g.F:443-817).
"""

from __future__ import annotations

import torch

from . import interp
from .common import as_dt, dtype_tiny8
from .tabulated_temp import MU_METAL


def _redshift(cloudy, zr):
    if cloudy.grid_rank == 3:
        return interp.redshift_index(zr, cloudy.par2,
                                     cloudy.grid_dimension[1])
    return None, None


def _node_tables(cfg, cloudy_prim, cloudy_met, pr, us, f, imetal):
    """Per-cell node arrays over the primordial table's temperature grid:
    internal energy e_k and net edot_k (code units) at each node.

    Mirrors the tabulated-mode branch of cool1d_multi
    (grackle: src/clib/cool1d_multi_g.F:917-1041) evaluated at every
    table temperature at once instead of at one iterated temperature.
    """
    d = f["density"]
    fh = cfg.HydrogenFractionByMass
    gamma = cfg.Gamma
    metal = f["metal"] if imetal else torch.zeros_like(d)
    rhoH = fh * (d - metal) if imetal else fh * d
    metallicity = (metal / d / cfg.SolarMetalFractionByMass
                   if imetal else torch.zeros_like(d))
    dom = us.dom
    log_n_h = torch.log10(rhoH * dom)

    rank = cloudy_prim.grid_rank
    log10T = [cloudy_prim.par1, cloudy_prim.par2,
              cloudy_prim.par3][rank - 1]         # (K,) node log10 temps
    zi0, end_int = _redshift(cloudy_prim, us.zr)
    T_k = torch.pow(10.0, log10T)                 # (K,)

    # mean molecular weight at every node: (N, K)
    mu_rows = interp.temperature_rows(
        cloudy_prim, cloudy_prim.mmw, log_n_h, us.zr, zi0, end_int)
    if imetal:
        mu_rows = d[:, None] / (
            (d - metal)[:, None] / mu_rows + metal[:, None] / MU_METAL)

    # energy nodes e_k = T_k / ((gamma-1) mu_k utem): (N, K); cummax
    # guards monotonicity against table noise
    e_nodes = T_k[None, :] / ((gamma - 1.0) * mu_rows * us.utem)
    e_nodes = torch.cummax(e_nodes, dim=1).values

    # --- net edot at every node (code units) ---
    # primordial Cloudy cooling (cool1d_multi_g.F:917-929; no CMB floor,
    # no heating in the restricted exact mode)
    prim_rows = interp.temperature_rows(
        cloudy_prim, cloudy_prim.cooling, log_n_h, us.zr, zi0, end_int)
    edot_rows = -torch.pow(10.0, prim_rows) * (rhoH * rhoH)[:, None]
    del prim_rows

    # electron number density from mu (cool1d_multi_g.F:932-945)
    myde_rows = 1.0 - mu_rows * (3.0 * fh + 1.0) / 4.0
    if imetal:
        myde_rows = myde_rows - mu_rows * (metal / (d * MU_METAL))[:, None]
    myde_rows = torch.clamp(d[:, None] * myde_rows / mu_rows, min=0.0)
    del mu_rows

    # Cloudy metal cooling with the CMB floor (cool1d_multi_g.F:1069-1097)
    if imetal and cfg.metal_cooling == 1:
        m_rank = cloudy_met.grid_rank
        m_par_t = [cloudy_met.par1, cloudy_met.par2,
                   cloudy_met.par3][m_rank - 1]
        m_zi0, m_end = _redshift(cloudy_met, us.zr)
        met_rows = interp.temperature_rows(
            cloudy_met, cloudy_met.cooling, log_n_h, us.zr, m_zi0, m_end)
        # the metal table's T grid can differ from the primordial one:
        # re-sample its rows at the primordial nodes by take + lerp
        i_m, f_m = interp._uniform_frac(log10T, m_par_t, met_rows.shape[1])
        lo = met_rows[:, i_m]
        met_at_nodes = lo + (met_rows[:, i_m + 1] - lo) * f_m[None, :]
        del lo
        edot_met = -torch.pow(10.0, met_at_nodes)
        del met_at_nodes
        if cfg.cmb_temperature_floor == 1:
            log10_tCMB = torch.log10(us.comp2)
            met_cmb = interp.rows_at_scalar_temperature(
                met_rows, m_par_t, log10_tCMB)  # (N,)
            edot_met = torch.where(
                (log10T[None, :] - log10_tCMB) < 2.0,
                edot_met + torch.pow(10.0, met_cmb)[:, None],
                edot_met,
            )
        del met_rows
        edot_rows = edot_rows + (
            edot_met * (metallicity * rhoH * rhoH)[:, None])
        del edot_met

    # Compton with the CMB (+ X-ray Compton, zero with UVB off)
    # (cool1d_multi_g.F:1027-1041)
    dom_inv = 1.0 / dom
    edot_rows = edot_rows - (
        us.comp1 * (T_k[None, :] - us.comp2) * myde_rows * dom_inv)
    edot_rows = edot_rows - (
        pr.comp_xray * (T_k[None, :] - pr.temp_xray) * myde_rows * dom_inv)
    return e_nodes, edot_rows


def _at(x, idx):
    """x[n, idx[n]] for every row n (take_along_axis)."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def exact_cool_step(cfg, cloudy_prim, cloudy_met, pr, us, f, dt,
                    imetal: bool):
    """Advance the internal energy by dt with the exact-integration
    scheme.  ``dt`` is a host float or a 0-d tensor on the fields'
    device (ops/common.as_dt).  Returns the new energy tensor."""
    d = f["density"]
    dt = as_dt(dt, d)
    e0 = f["energy"]
    tiny8 = dtype_tiny8(d.dtype)

    e_nodes, edot_rows = _node_tables(
        cfg, cloudy_prim, cloudy_met, pr, us, f, imetal)
    c = torch.clamp(-edot_rows, min=0.0)          # cooling rate, >= 0
    del edot_rows
    cooling = c > tiny8                           # node actively cooling
    n_k = e_nodes.shape[1]

    # --- segment power laws (Townsend 2009 eq. 24-26 analogue in e) ---
    e_lo, e_hi = e_nodes[:, :-1], e_nodes[:, 1:]
    seg_ok = cooling[:, :-1] & cooling[:, 1:] & (e_hi > e_lo)
    del cooling
    safe_clo = torch.where(seg_ok, c[:, :-1], 1.0)
    ratio_e = e_hi / torch.clamp(e_lo, min=tiny8)
    alpha = torch.log(torch.where(seg_ok, c[:, 1:], 1.0) / safe_clo) \
        / torch.log(torch.clamp(ratio_e, min=1.0 + 1e-7))
    one_m_a = 1.0 - alpha
    near1 = torch.abs(one_m_a) < 1.0e-4
    # full-segment crossing time d * int_{e_lo}^{e_hi} de / c(e)
    tau_pow = (
        d[:, None] * e_lo / (safe_clo * torch.where(near1, 1.0, one_m_a))
        * (torch.pow(ratio_e, torch.where(near1, 0.0, one_m_a)) - 1.0)
    )
    del one_m_a
    tau_log = d[:, None] * e_lo / safe_clo * torch.log(ratio_e)
    del safe_clo, ratio_e
    tau = torch.where(seg_ok, torch.where(near1, tau_log, tau_pow), 0.0)
    del tau_pow, tau_log, near1

    # prefix time-to-bottom along cooling-only segments: Y[k] = time to
    # cool from node k down to node 0 through cooling segments
    Y = torch.cat([torch.zeros_like(d)[:, None], torch.cumsum(tau, dim=1)],
                  dim=1)  # (N, K)
    del tau

    # per-cell reachable floor: the highest blocked segment at or below
    # the starting segment caps the descent at its top node
    below = e_nodes <= e0[:, None]
    n_below = below.sum(dim=1)
    del below
    s0 = torch.clamp(n_below - 1, 0, n_k - 2)  # starting segment index
    seg_idx = torch.arange(n_k - 1, device=d.device)
    blocked_below = (~seg_ok) & (seg_idx[None, :] <= s0[:, None])
    # floor node = (highest blocked segment index)+1, or 0 if none
    floor_node = torch.where(blocked_below, seg_idx[None, :] + 1,
                             0).amax(dim=1)
    del blocked_below

    e_s0 = _at(e_nodes, s0)
    c_s0 = _at(c, s0)
    a_s0 = _at(alpha, s0)
    ok_s0 = _at(seg_ok, s0)
    Y_s0 = _at(Y, s0)
    Y_floor = _at(Y, floor_node)

    # partial time from node s0 up to e0 (same closed forms); for e0
    # beyond the top node this extrapolates the edge power law, matching
    # the clamped-index extrapolation of the table interpolators
    x0 = torch.clamp(e0 / torch.clamp(e_s0, min=tiny8), min=1.0)
    om = 1.0 - a_s0
    nr1 = torch.abs(om) < 1.0e-4
    c_s0 = torch.where(ok_s0, c_s0, 1.0)
    part_pow = (
        d * e_s0 / (c_s0 * torch.where(nr1, 1.0, om))
        * (torch.pow(x0, torch.where(nr1, 0.0, om)) - 1.0)
    )
    part_log = d * e_s0 / c_s0 * torch.log(x0)
    Y_e0 = Y_s0 + torch.where(ok_s0, torch.where(nr1, part_log, part_pow),
                              0.0)

    # --- the step: Y(e_new) = Y(e0) - dt, clamped at the floor ---
    Y_new = torch.clamp(Y_e0 - dt, min=Y_floor, max=Y_e0)

    # locate the segment containing Y_new and invert the closed form
    s_new = torch.clamp((Y <= Y_new[:, None]).sum(dim=1) - 1, 0, n_k - 2)
    e_s = _at(e_nodes, s_new)
    c_s = _at(c, s_new)
    a_s = _at(alpha, s_new)
    ok_s = _at(seg_ok, s_new)
    Y_s = _at(Y, s_new)
    del e_nodes, c, alpha, seg_ok, Y
    dY = torch.clamp(Y_new - Y_s, min=0.0)
    om_s = 1.0 - a_s
    nr1_s = torch.abs(om_s) < 1.0e-4
    c_safe = torch.where(ok_s, c_s, 1.0)
    base = 1.0 + dY * c_safe * torch.where(nr1_s, 1.0, om_s) / (
        d * torch.clamp(e_s, min=tiny8))
    e_pow = e_s * torch.pow(torch.clamp(base, min=tiny8),
                            1.0 / torch.where(nr1_s, 1.0, om_s))
    e_log = e_s * torch.exp(dY * c_safe / (d * torch.clamp(e_s, min=tiny8)))
    e_new = torch.where(nr1_s, e_log, e_pow)
    e_new = torch.where(ok_s, e_new, e_s)

    # net-heating cells (T at/below the equilibrium point) are held;
    # cells already below the table bottom are held as well
    hold = ~ok_s0 & (Y_e0 <= Y_s0)
    start_heating = n_below == 0
    e_new = torch.where(hold | start_heating, e0, e_new)
    # never exceed the starting energy (pure cooling step)
    return torch.minimum(e_new, e0)
