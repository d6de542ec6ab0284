"""The subcycle body's elementwise network region, plain PyTorch (port of
grackle_tpu/ops/network.py).

This is the code between the table lookups and the loop bookkeeping of
one subcycle iteration (grackle: src/clib/solve_rate_cool_g.F:554-813):
the dedot/HIdot rate sums, the chemistry timestep limiter, the energy
timestep + energy update, the BE Gauss-Seidel species sweep, and the
per-cell clock/retirement updates.  It is purely elementwise: no lookups,
no reductions, no transcendentals.

:func:`network_update` is the plain twin of the CUDA kernel
csrc/network_update.cu (ops/network_kernel.py launches it): the CPU tests
hold this function against the JAX package's, and the kernel is held
against this function on the card.  Every operation here has its
counterpart, in the same order, in the kernel source; change them
together.
"""

from __future__ import annotations

from typing import Any

import torch

from ..constants import tiny
from . import chemistry_step as cs
from .common import div_host, dtype_huge8, dtype_tiny8, dtype_tolerance


def _two_sum(hi, lo, x):
    """(hi + lo) + x as a renormalized pair (Neumaier two-sum).

    The branch picks the error term formulation valid for the larger
    operand; the trailing renormalization keeps hi the correctly-rounded
    total so consumers that read only the hi word see the best value.
    Idempotent on a renormalized pair with x = 0 (masked lanes stay
    bit-frozen).  Relies on uncontracted IEEE adds: PyTorch runs each
    add as its own op."""
    s = hi + x
    err = torch.where(
        torch.abs(hi) >= torch.abs(x), (hi - s) + x, (x - s) + hi
    )
    lo = lo + err
    hi2 = s + lo
    lo2 = lo - (hi2 - s)
    return hi2, lo2


def network_field_keys(cfg):
    """The field-dict keys the network region reads."""
    from .solver import species_names

    keys = ["density", "energy"] + species_names(cfg)
    if cfg.use_radiative_transfer == 1:
        keys.append("RT_HI_ionization_rate")
        if cfg.radiative_transfer_hydrogen_only == 0:
            keys += ["RT_HeI_ionization_rate", "RT_HeII_ionization_rate"]
    return keys


def network_update(
    cfg,
    us,
    dt,
    f,
    rs,
    cool_v,
    carry_v,
    h2_limit,
) -> Any:
    """One subcycle's elementwise update (solve_rate_cool_g.F:554-813).

    Parameters
    ----------
    us : object with ``dom`` and ``chunit`` host-float attributes (the
        only UnitScalars fields this region consumes).
    dt : full-step timestep (host float).
    f : field dict restricted to :func:`network_field_keys`.
    rs : RateState from lookup_cool_rates (None when
        primordial_chemistry == 0); only ``k``/``shields``/``h2dust``
        are read.
    cool_v : dict with ``edot``, ``tgas``, ``p2d``, ``rhoH``,
        ``tgasold``, ``tdust`` from cool1d_multi.
    carry_v : dict with ``ttot``, ``tgasold``, ``tdust``,
        ``dedot_prev``, ``HIdot_prev``, ``itmask`` (bool),
        ``cell_it`` (int32), ``capped`` (bool), ``dtit_prev``
        (+ ``energy_lo``/``ttot_lo`` with compensated_sums=1).
    h2_limit : high-density H2-equilibrium dt limit tensor
        (+huge where inactive; None when primordial_chemistry <= 1).

    Returns the new carry dict (same keys as ``carry_v`` plus
    ``fields`` holding the updated species + energy).
    """
    from .solver import species_names

    ispecies = cfg.primordial_chemistry
    dtype = f["density"].dtype
    tiny8 = dtype_tiny8(dtype)
    huge8 = dtype_huge8(dtype)
    tolerance = dtype_tolerance(dtype)

    compensated = cfg.compensated_sums == 1
    itmask = carry_v["itmask"]
    ttot = carry_v["ttot"]
    it = carry_v["cell_it"]
    edot = cool_v["edot"]
    dtit = torch.full_like(edot, huge8)
    # Compensated mode: the true accumulated clock is ttot + ttot_lo;
    # every `dt - ttot` residual uses the compensated value so the
    # subcycle partition sums to dt without f32 drift.
    if compensated:
        t_resid = (dt - ttot) - carry_v["ttot_lo"]
    else:
        t_resid = dt - ttot

    if ispecies > 0:
        dedot, HIdot, edot = cs.rate_timestep(
            cfg, rs, f, us, edot, cool_v["rhoH"]
        )

        # dt limiter (solve_rate_cool_g.F:554-692)
        de, HI = f["de"], f["HI"]
        dedot = torch.where(
            torch.abs(dedot) < tiny8, torch.clamp(de, max=tiny), dedot
        )
        HIdot = torch.where(
            torch.abs(HIdot) < tiny8, torch.clamp(HI, max=tiny), HIdot
        )
        # balanced-rate zeroing (solve_rate_cool_g.F:566-572)
        balanced = (
            torch.minimum(
                torch.abs(rs.k["k1"] * de * HI),
                torch.abs(rs.k["k2"] * f["HII"] * de),
            ) / torch.maximum(torch.abs(dedot), torch.abs(HIdot))
        ) > 1.0e6
        dedot = torch.where(balanced, torch.full_like(dedot, tiny8), dedot)
        HIdot = torch.where(balanced, torch.full_like(HIdot, tiny8), HIdot)
        # high-iteration damping (solve_rate_cool_g.F:580-583)
        use_prev = it > 50
        dedot = torch.where(
            use_prev,
            torch.minimum(torch.abs(dedot), torch.abs(carry_v["dedot_prev"])),
            dedot,
        )
        HIdot = torch.where(
            use_prev,
            torch.minimum(torch.abs(HIdot), torch.abs(carry_v["HIdot_prev"])),
            HIdot,
        )
        acc = cfg.subcycle_accuracy
        dtit = torch.minimum(
            torch.minimum(
                torch.abs(acc * de / dedot),
                torch.abs(acc * HI / HIdot),
            ),
            torch.clamp(t_resid, max=0.5 * dt),
        )
        if ispecies > 1:
            # high-density H2-equilibrium limit, evaluated outside this
            # region (it needs a table fetch); +huge where inactive, so
            # the min reproduces a where(apply, min, dtit) bit-exactly
            # (dtit <= 0.5*dt < huge here).
            dtit = torch.minimum(dtit, h2_limit)
        # NOTE: the reference's iter>10 anti-ringing clamp
        # (solve_rate_cool_g.F:644-646) compares against a dtit that
        # was just reset to huge at the top of the subcycle, making it
        # a no-op; reproduced by omission.

    # energy timestep (solve_rate_cool_g.F:698-750); div_host divides
    # as the kernel does on every device
    energy = torch.clamp(div_host(cool_v["p2d"], cfg.Gamma - 1.0),
                         min=tiny8)
    edot = torch.where(
        (cool_v["tgas"] <= 1.01 * cfg.TemperatureStart) & (edot < 0.0),
        torch.full_like(edot, tiny8),
        edot,
    )
    edot = torch.where(torch.abs(edot) < tiny8,
                       torch.full_like(edot, tiny8), edot)
    dtit = torch.minimum(
        torch.abs(cfg.subcycle_accuracy * energy / edot),
        torch.minimum(t_resid, dtit),
    )

    # energy update (solve_rate_cool_g.F:754-773); in compensated mode
    # the increment goes through a Neumaier two-sum against the carried
    # low part, eliminating f32 summation drift over the subcycle
    # sequence.
    new_fields = dict(f)
    energy_lo = carry_v.get("energy_lo") if compensated else None
    if cfg.with_radiative_cooling == 1:
        if compensated:
            incr = torch.where(itmask, edot / f["density"] * dtit,
                               torch.zeros_like(dtit))
            e_hi, e_lo = _two_sum(f["energy"], energy_lo, incr)
            new_fields["energy"] = e_hi
            energy_lo = e_lo
        else:
            new_fields["energy"] = torch.where(
                itmask,
                f["energy"] + edot / f["density"] * dtit,
                f["energy"],
            )

    # species update (solve_rate_cool_g.F:780-796)
    dedot_prev = carry_v["dedot_prev"]
    HIdot_prev = carry_v["HIdot_prev"]
    if ispecies > 0:
        stepped, dedot_prev_new, HIdot_prev_new = cs.step_rate(
            cfg, rs, new_fields, us, dtit, cool_v["rhoH"]
        )
        for name in species_names(cfg):
            new_fields[name] = torch.where(
                itmask, stepped[name], new_fields[name]
            )
        dedot_prev = torch.where(itmask, dedot_prev_new, dedot_prev)
        HIdot_prev = torch.where(itmask, HIdot_prev_new, HIdot_prev)

    # advance cell clocks and retire finished cells
    # (solve_rate_cool_g.F:803-813)
    if compensated:
        step_t = torch.where(itmask, dtit, torch.full_like(dtit, dt))
        t_hi, t_lo = _two_sum(ttot, carry_v["ttot_lo"], step_t)
        # the min(..., dt) clamp: once the compensated clock reaches dt
        # the pair snaps to (dt, 0) exactly, like the uncompensated min
        done = (t_hi + t_lo) >= dt
        ttot_new = torch.where(done, torch.full_like(t_hi, dt), t_hi)
        ttot_lo_new = torch.where(done, torch.zeros_like(t_lo), t_lo)
        unfinished = torch.abs((dt - ttot_new) - ttot_lo_new) \
            >= tolerance * dt
    else:
        ttot_new = torch.clamp(
            ttot + torch.where(itmask, dtit, torch.full_like(dtit, dt)),
            max=dt,
        )
        unfinished = torch.abs(dt - ttot_new) >= tolerance * dt
    cell_it_new = carry_v["cell_it"] + itmask.to(torch.int32)
    hit_cap = cell_it_new >= cfg.max_iterations
    itmask_new = itmask & unfinished & ~hit_cap
    capped_new = carry_v["capped"] | (itmask & unfinished & hit_cap)

    tgasold_new = torch.where(itmask, cool_v["tgasold"], carry_v["tgasold"])
    tdust_new = torch.where(itmask, cool_v["tdust"], carry_v["tdust"])

    state_keys = ["energy"] + species_names(cfg)
    comp_out = {}
    if compensated:
        comp_out = dict(energy_lo=energy_lo, ttot_lo=ttot_lo_new)
    return dict(
        **comp_out,
        fields={k: new_fields[k] for k in state_keys},
        ttot=ttot_new,
        tgasold=tgasold_new,
        tdust=tdust_new,
        dedot_prev=dedot_prev,
        HIdot_prev=HIdot_prev,
        itmask=itmask_new,
        cell_it=cell_it_new,
        capped=capped_new,
        dtit_prev=torch.where(itmask, dtit, carry_v["dtit_prev"]),
    )
