"""Subcycled chemistry + cooling solver (port of grackle_tpu/ops/solver.py).

Rebuild of the reference's main kernel driver
(grackle: src/clib/solve_rate_cool_g.F:6-892).  The reference parallelizes
over grid rows with OpenMP and subcycles each row until every cell reaches
dt; here the whole flat cell array advances together in one loop whose
per-cell mask retires cells individually.

Every subcycle runs the network region through the plain twin
(ops/network.py) on any device: this copy has no CUDA kernel.  The loops go through
``ops/device_loop.device_while``: eagerly, the subcycle loop reads its
exit condition on the host only every ``CHECK_EVERY`` subcycles (a
subcycle in which no cell is active changes no output: every carry
update is masked, so running up to ``CHECK_EVERY - 1`` of them past the
last active cell is exact); inside a CUDA-graph capture each loop is a
conditional WHILE node and the solve reads nothing on the host.  ``dt``
is a host float or a 0-d tensor (ops/common.as_dt); the solves convert
it on entry.

:func:`solve_rate_cool` is the monolithic solve (the port's compacted
solve, which runs the same per-cell subcycles on tiles and gathered
batches, is left out of this copy).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..constants import tiny
from . import chemistry_step as cs
from .common import as_dt, dtype_huge8, ipow
from .cooling import cool1d_multi
from .device_loop import device_while
from .network import network_field_keys
from .network import network_update

_SPECIES_1 = ["de", "HI", "HII", "HeI", "HeII", "HeIII"]
_SPECIES_2 = ["HM", "H2I", "H2II"]
_SPECIES_3 = ["DI", "DII", "HDI"]

#: subcycles between reads of the loop's "any cell active" flag (a host
#: read when eager, the condition kernel inside a capture)
CHECK_EVERY = 8


def species_names(cfg):
    names = []
    if cfg.primordial_chemistry > 0:
        names += _SPECIES_1
    if cfg.primordial_chemistry > 1:
        names += _SPECIES_2
    if cfg.primordial_chemistry > 2:
        names += _SPECIES_3
    return names


def scale_fields(cfg, f, factor, imetal: bool):
    """Comoving <-> proper density scaling
    (solve_rate_cool_g.F:898-989)."""
    out = dict(f)
    out["density"] = f["density"] * factor
    for name in species_names(cfg):
        out[name] = f[name] * factor
    if imetal:
        out["metal"] = f["metal"] * factor
    if cfg.use_dust_density_field == 1:
        out["dust"] = f["dust"] * factor
    return out


def ceiling_species(cfg, f, imetal: bool):
    """Floor species at tiny (solve_rate_cool_g.F:994-1070)."""
    out = dict(f)
    if cfg.primordial_chemistry > 0:
        for name in ["de", "HI", "HII", "HeI", "HeII"]:
            out[name] = torch.clamp(f[name], min=tiny)
        out["HeIII"] = torch.clamp(f["HeIII"], min=1.0e-5 * tiny)
    if cfg.primordial_chemistry > 1:
        for name in _SPECIES_2:
            out[name] = torch.clamp(f[name], min=tiny)
    if cfg.primordial_chemistry > 2:
        for name in _SPECIES_3:
            out[name] = torch.clamp(f[name], min=tiny)
    if imetal:
        out["metal"] = torch.clamp(f["metal"], min=tiny)
    return out


def _h2_apply_mask(cool, f, us, itmask):
    """Cells where the high-density H2 equilibrium limiter fires
    (solve_rate_cool_g.F:592-595): rho*dom > 1e8 with net heating."""
    return (f["density"] * us.dom > 1.0e8) & (cool.edot > 0.0) & itmask


def _h2_limit_value(cfg, tables, rs, cool, f, us):
    """The raw per-cell H2-equilibrium dt limit
    (solve_rate_cool_g.F:596-643): at rho > 1e8 mh with heating, the dt
    at which the k13/k22 equilibrium H abundance changes by ~10%.
    Only meaningful on cells where :func:`_h2_apply_mask` holds."""
    fh = cfg.HydrogenFractionByMass
    d = f["density"]
    tgas = cool.tgas
    dlogtem = (
        math.log(cfg.TemperatureEnd) - math.log(cfg.TemperatureStart)
    ) / (cfg.NumberOfTemperatureBins - 1)
    ti = rs.ti
    # the float64 bin edges round to the solver dtype here, the width
    # after the subtraction (lookup.table_index)
    t1, t2 = ti.t1.to(d.dtype), ti.t2.to(d.dtype)
    width = (ti.t2 - ti.t1).to(d.dtype)
    k13a, k22a = tables.k13, tables.k22
    lo13, hi13 = k13a[ti.idx], k13a[ti.idx + 1]
    lo22, hi22 = k22a[ti.idx], k22a[ti.idx + 1]

    def heq_at(eqt):
        eqtdef = (eqt - t1) / width
        k13_i = lo13 + (hi13 - lo13) * eqtdef
        k22_i = lo22 + (hi22 - lo22) * eqtdef
        return (-1.0 / (4.0 * k22_i)) * (
            k13_i - torch.sqrt(8.0 * k13_i * k22_i * fh * d
                               + k13_i * k13_i)
        )

    logt = torch.log(tgas)
    eqt2 = torch.minimum(logt + 0.1 * dlogtem, t2)
    eqt1 = torch.maximum(logt - 0.1 * dlogtem, t1)
    heq2 = heq_at(eqt2)
    heq1 = heq_at(eqt1)
    dheq = (
        torch.abs(heq2 - heq1) / (torch.exp(eqt2) - torch.exp(eqt1))
    ) * (tgas / cool.p2d) * cool.edot
    k13, k22 = rs.k["k13"], rs.k["k22"]
    heq = (-1.0 / (4.0 * k22)) * (
        k13 - torch.sqrt(8.0 * k13 * k22 * fh * d + k13 * k13)
    )
    return cfg.subcycle_accuracy * heq / dheq


def _h2_equilibrium_limit(cfg, tables, rs, cool, f, us, itmask):
    """High-density H2 equilibrium timestep limit, value form: the
    per-cell dt limit (+huge where inactive), which the network region
    folds into its dt minimum.  Evaluated on every cell and selected with
    ``torch.where`` (no host check of "any cell dense"): where the
    limiter does not fire the result is +huge, exactly what the JAX
    package's ``lax.cond`` skip returns."""
    huge8 = dtype_huge8(f["density"].dtype)
    apply = _h2_apply_mask(cool, f, us, itmask)
    limit = _h2_limit_value(cfg, tables, rs, cool, f, us)
    return torch.where(apply, limit, torch.full_like(limit, huge8))


@dataclasses.dataclass(frozen=True)
class SolveResult:
    fields: Any
    n_iterations: Any  # scalar int: subcycles taken (max over cells)
    converged: Any  # [N] bool: cells that reached dt within max_iterations
    cell_iterations: Any  # [N] int32: subcycles each cell was active for
    # subcycles run (network launches), masked ones too, and the outer
    # batches of the compacted solve: Python ints when eager, 0-d int64
    # tensors counted on the device inside a capture
    subcycles: Any = 0
    trips: Any = 0


def prepare_fields(cfg, f, us, imetal: bool, comoving: bool):
    """Pre-loop field conditioning: comoving scaling + species ceiling
    (solve_rate_cool_g.F:347-355, 994-1070).  Returns the conditioned
    fields and the initial iteration mask."""
    f = dict(f)
    if comoving:
        f = scale_fields(cfg, f, ipow(us.aye, -3), imetal)
    f = ceiling_species(cfg, f, imetal)

    itmask0 = torch.ones(f["density"].shape, dtype=torch.bool,
                         device=f["density"].device)
    # coupled radiative-transfer intermediate stepping masks
    # (solve_rate_cool_g.F:418-439)
    if (cfg.use_radiative_transfer == 1
            and cfg.radiative_transfer_coupled_rate_solver == 1):
        has_rad = f["RT_HI_ionization_rate"] > 0
        if cfg.radiative_transfer_intermediate_step == 1:
            itmask0 = has_rad
        else:
            itmask0 = ~has_rad
    return f, itmask0


def split_state(cfg, f):
    """Partition the field dict into the loop-mutable state (energy +
    chemical species) and read-only constants (density, metal, dust,
    RT/heating rate arrays, shielding fields)."""
    state_keys = set(species_names(cfg)) | {"energy"}
    f_state = {k: v for k, v in f.items() if k in state_keys}
    f_const = {k: v for k, v in f.items() if k not in state_keys}
    return f_state, f_const


def init_carry(f_state, itmask0, cfg=None):
    """Build the subcycle loop carry: all loop-mutable per-cell state.

    With ``cfg.compensated_sums == 1`` the carry additionally holds the
    Neumaier compensation terms for the energy and subcycle-clock sums
    (``energy_lo`` / ``ttot_lo``; see ops/network.py)."""
    ref = f_state["energy"]
    zeros = torch.zeros_like(ref)
    comp = {}
    if cfg is not None and cfg.compensated_sums == 1:
        comp = dict(energy_lo=zeros, ttot_lo=zeros)
    return dict(
        **comp,
        fields=dict(f_state),
        ttot=zeros,
        tgasold=zeros,
        tdust=zeros,  # warm start for the dust equilibrium solve
        dedot_prev=zeros,
        HIdot_prev=zeros,
        itmask=itmask0,
        cell_it=torch.zeros(ref.shape, dtype=torch.int32,
                            device=ref.device),
        # set when a cell is retired by the max_iterations cap rather
        # than by reaching dt (solve_rate_cool_g.F:823-843)
        capped=torch.zeros(ref.shape, dtype=torch.bool, device=ref.device),
        # last subcycle dt taken (predicts the residual work for
        # converged-cell compaction)
        dtit_prev=zeros,
    )


def subcycle(cfg, tables, cloudy_prim, cloudy_met, pr, us, carry, dt,
             imetal: bool, cloudy_data_new: bool = True, const_f=None,
             l_h2shield_field=None, inputs_out=None):
    """One subcycle iteration (solve_rate_cool_g.F:443-813): cooling
    rates, rate lookups, the H2-equilibrium limit, then the network
    region.  Returns the new carry.

    ``inputs_out``, when a dict, receives the network region's inputs
    (the operands the kernel reads) for this subcycle."""
    f = dict(const_f)
    f.update(carry["fields"])
    itmask = carry["itmask"]
    first_iter = carry["cell_it"] == 0

    cool = cool1d_multi(
        cfg, tables, cloudy_prim, cloudy_met, pr, us, f,
        carry["tgasold"], first_iter, imetal, cloudy_data_new,
        tdust_prev=carry["tdust"],
    )
    rs = None
    if cfg.primordial_chemistry > 0:
        rs = cs.lookup_cool_rates(
            cfg, tables, pr, us, f, cool.tgas, cool.mmw, cool.tdust,
            cool.dust2gas, l_h2shield_field, imetal,
        )
    h2_limit = None
    if cfg.primordial_chemistry > 1:
        h2_limit = _h2_equilibrium_limit(
            cfg, tables, rs, cool, f, us, itmask
        )
    f_net = {k: f[k] for k in network_field_keys(cfg)}
    cool_v = dict(
        edot=cool.edot, tgas=cool.tgas, p2d=cool.p2d,
        rhoH=cool.rhoH, tgasold=cool.tgasold, tdust=cool.tdust,
    )
    carry_v = {k: v for k, v in carry.items() if k != "fields"}
    if inputs_out is not None:
        inputs_out.update(us=us, dt=dt, f=f_net, rs=rs, cool_v=cool_v,
                          carry_v=carry_v, h2_limit=h2_limit)
    return network_update(cfg, us, dt, f_net, rs, cool_v, carry_v,
                          h2_limit)


def run_subcycles(
    cfg,
    tables,
    cloudy_prim,
    cloudy_met,
    pr,
    us,
    carry0,
    dt,
    imetal: bool,
    cloudy_data_new: bool = True,
    chunk: int | None = None,
    const_f=None,
    l_h2shield_field=None,
):
    """Run up to ``chunk`` subcycle iterations (default: to the
    max_iterations cap), stopping early once no cell is active, and
    retiring converged cells via the per-cell mask.
    The per-cell update is purely elementwise and iteration bookkeeping
    (first-iteration init, >50-iteration damping, the max_iterations
    cap) uses the per-cell subcycle counter.  (The reference is likewise
    row-granular: each OpenMP row subcycles on its own counter,
    solve_rate_cool_g.F:369-403.)

    ``const_f`` holds the read-only field tensors (split_state).

    Mirrors the subcycle loop of solve_rate_cool_g.F:443-813.  Returns
    (carry, subcycles run): the loop stops at ``chunk`` subcycles, also
    when ``chunk`` is not a multiple of CHECK_EVERY.
    """
    if const_f is None or "density" not in const_f:
        raise ValueError(
            "run_subcycles requires const_f (the read-only field dict "
            "from split_state); density is always routed there"
        )
    if chunk is None:
        chunk = cfg.max_iterations

    def step(carry, _):
        return subcycle(
            cfg, tables, cloudy_prim, cloudy_met, pr, us, carry, dt,
            imetal, cloudy_data_new, const_f, l_h2shield_field,
        )

    return device_while(lambda c: c["itmask"], step, carry0, chunk,
                        CHECK_EVERY)


def finalize_fields(cfg, f, us, imetal: bool, comoving: bool):
    """Post-loop rescale + conservation renormalization
    (solve_rate_cool_g.F:870-888)."""
    # proper -> comoving (solve_rate_cool_g.F:870-878)
    if comoving:
        f = scale_fields(cfg, f, ipow(us.aye, 3), imetal)
    # conservation renormalization (solve_rate_cool_g.F:884-888)
    if cfg.primordial_chemistry > 0:
        f = cs.make_consistent(cfg, f, imetal)
    return f


def solve_rate_cool(
    cfg,
    tables,
    cloudy_prim,
    cloudy_met,
    pr,
    us,
    f,
    dt,
    imetal: bool,
    cloudy_data_new: bool = True,
    l_h2shield_field=None,
    comoving: bool = False,
) -> SolveResult:
    """Advance the chemistry network and gas energy by dt.

    Mirrors solve_rate_cool_g.F:321-892: comoving scaling, species ceiling,
    masked subcycle loop (cooling-rate eval -> rate lookup -> dt limiter ->
    energy update -> BE Gauss-Seidel species step), rescaling, and final
    conservation renormalization.
    """
    dt = as_dt(dt, f["density"])
    f, itmask0 = prepare_fields(cfg, f, us, imetal, comoving)
    f_state, f_const = split_state(cfg, f)
    carry = init_carry(f_state, itmask0, cfg)
    carry, steps = run_subcycles(
        cfg, tables, cloudy_prim, cloudy_met, pr, us, carry, dt,
        imetal=imetal, cloudy_data_new=cloudy_data_new,
        const_f=f_const, l_h2shield_field=l_h2shield_field,
    )
    return _result(cfg, f_const, carry, us, imetal, comoving, steps)


def _result(cfg, f_const, carry, us, imetal, comoving, subcycles,
            trips=0) -> SolveResult:
    """The solve's fields (rescaled and renormalized) and diagnostics
    from the final loop carry."""
    out = dict(f_const)
    out.update(carry["fields"])
    if cfg.compensated_sums == 1:
        # fold the carried compensation into the returned energy
        out["energy"] = out["energy"] + carry["energy_lo"]
    fields = finalize_fields(cfg, out, us, imetal, comoving)
    return SolveResult(
        fields=fields,
        n_iterations=torch.max(carry["cell_it"]),
        converged=~carry["capped"],
        cell_iterations=carry["cell_it"],
        subcycles=subcycles,
        trips=trips,
    )
