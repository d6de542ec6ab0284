"""Subcycled chemistry + cooling solver (port of grackle_tpu/ops/solver.py).

Rebuild of the reference's main kernel driver
(grackle: src/clib/solve_rate_cool_g.F:6-892).  The reference parallelizes
over grid rows with OpenMP and subcycles each row until every cell reaches
dt; here the whole flat cell array advances together in one loop whose
per-cell mask retires cells individually.

Every subcycle runs the network region through
``ops/network_kernel.network_update``: the CUDA kernel on CUDA tensors,
the plain twin (ops/network.py) on CPU tensors.  The loops go through
``ops/device_loop.device_while``: eagerly, the subcycle loop reads its
exit condition on the host only every ``CHECK_EVERY`` subcycles (a
subcycle in which no cell is active changes no output: every carry
update is masked, so running up to ``CHECK_EVERY - 1`` of them past the
last active cell is exact); inside a CUDA-graph capture each loop is a
conditional WHILE node and the solve reads nothing on the host.  ``dt``
is a host float or a 0-d tensor (ops/common.as_dt); the solves convert
it on entry.

:func:`solve_rate_cool` is the monolithic solve;
:func:`solve_rate_cool_compacted` runs the same per-cell subcycles on tiles
and then on gathered batches of the unconverged cells.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import tracing
from ..constants import tiny
from . import chemistry_step as cs
from . import rates_kernel
from .common import as_dt, ipow
from .cooling import cool1d_multi
from .device_loop import device_while, zero_steps
from .network import network_field_keys
from .network_kernel import network_update

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
    rates, rate lookups and the H2-equilibrium limit
    (ops/rates_kernel.rate_lookup), then the network region.  Returns the
    new carry.

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
    rs = h2_limit = None
    if cfg.primordial_chemistry > 0:
        # the rate lookup and, at chemistry 2 and 3, the H2-equilibrium
        # limit: one launch on the card, the twin on the CPU
        with tracing.rates_block(f["density"]):
            rs, h2_limit = rates_kernel.rate_lookup(
                cfg, tables, pr, us, f, cool, itmask, l_h2shield_field)
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


def warm_tile_width(batch):
    """Warm-phase tile width of the compacted solve: max(batch, 262144),
    the JAX package's default (its GTPU_WARM_TILE override is not
    carried over)."""
    return max(batch, 262_144)


#: per-cell carry entries besides the fields and the three flags
_AUX_KEYS = ["ttot", "tgasold", "tdust", "dedot_prev", "HIdot_prev",
             "dtit_prev"]
_FLAG_KEYS = ["cell_it", "itmask", "capped"]


def solve_rate_cool_compacted(
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
    warm: int = 16,
    batch: int = 16384,
    tile: int | None = None,
) -> SolveResult:
    """solve_rate_cool with converged-cell compaction.

    The per-cell subcycle count is heavy-tailed, so the monolithic loop
    makes every cell ride along until the slowest converges.  Here:

    1. ``warm`` subcycles run on contiguous tiles of ``tile`` cells
       (default :func:`warm_tile_width`); the last tile is clamped to
       ``[n - tile, n)``, so its overlap re-runs cells that are already
       done (masked no-ops) or advances active ones earlier;
    2. outer trips (one loop step each: a host read when eager, the
       outer WHILE node of a capture, with the subcycle loop's node
       nested in it) take the ``batch`` active cells
       with the most predicted residual subcycles ``(dt - ttot) /
       dtit_prev`` (``torch.topk``, indices sorted), gather them, run
       them for up to max_iterations subcycles and scatter them back.

    Every subcycle's bookkeeping is per cell, so the per-cell subcycle
    sequence, and with it every result, is that of the monolithic loop
    whatever the tiles and batches (bit-identical where each element of
    an elementwise op is computed alike wherever it sits in the tensor).
    The carry is packed as rows of one ``(C, N)`` tensor (mutable state
    ``M``, gathered and scattered) and the read-only fields as ``K``
    (gathered only), so each trip is one gather and one scatter and
    every row the network kernel reads is contiguous.
    """
    dt = as_dt(dt, f["density"])
    f, itmask0 = prepare_fields(cfg, f, us, imetal, comoving)
    f_state, f_const = split_state(cfg, f)
    carry = init_carry(f_state, itmask0, cfg)
    dtype = f["density"].dtype
    n = f["density"].shape[0]
    batch = min(batch, n)
    tile = warm_tile_width(batch) if tile is None else tile

    state_keys = sorted(carry["fields"])
    const_keys = sorted(f_const)
    aux_keys = list(_AUX_KEYS)
    if cfg.compensated_sums == 1:
        aux_keys += ["energy_lo", "ttot_lo"]
    row = {key: j for j, key in
           enumerate(state_keys + aux_keys + _FLAG_KEYS)}

    def pack(c):
        # exact: cell_it (< max_iterations) and the masks are small
        # integers in the solver dtype
        cols = [c["fields"][k] for k in state_keys]
        cols += [c[k] for k in aux_keys]
        cols += [c[k].to(dtype) for k in _FLAG_KEYS]
        return torch.stack(cols)

    def unpack(m):
        c = {k: m[row[k]] for k in aux_keys}
        c["fields"] = {k: m[row[k]] for k in state_keys}
        c["cell_it"] = m[row["cell_it"]].to(torch.int32)
        c["itmask"] = m[row["itmask"]] > 0
        c["capped"] = m[row["capped"]] > 0
        return c

    k_rows = [f_const[k] for k in const_keys]
    if l_h2shield_field is not None:
        k_rows.append(l_h2shield_field)
    K = torch.stack(k_rows)

    def run(m, k, n_steps):
        consts = {key: k[j] for j, key in enumerate(const_keys)}
        l_h2 = k[len(const_keys)] if l_h2shield_field is not None else None
        c, steps = run_subcycles(
            cfg, tables, cloudy_prim, cloudy_met, pr, us, unpack(m), dt,
            imetal=imetal, cloudy_data_new=cloudy_data_new, chunk=n_steps,
            const_f=consts, l_h2shield_field=l_h2,
        )
        return pack(c), steps

    M = pack(carry)
    subcycles = zero_steps(M)
    if warm > 0:
        width = min(tile, n)
        for i in range(-(-n // width)):
            start = min(i * width, n - width)
            cells = slice(start, start + width)
            packed, steps = run(M[:, cells], K[:, cells], warm)
            M[:, cells] = packed
            subcycles = subcycles + steps

    def trip(state, _):
        m, done = state
        mask, ttot, dtit = (m[row["itmask"]], m[row["ttot"]],
                            m[row["dtit_prev"]])
        residual = (dt - ttot) / torch.clamp(dtit, min=tiny)
        key = torch.where(mask > 0, residual,
                          torch.full_like(residual, -1.0))
        # batch composition never changes a cell's result; ascending
        # indices keep the gather and scatter in memory order
        idx = torch.sort(torch.topk(key, batch, sorted=False).indices).values
        packed, steps = run(m.index_select(1, idx), K.index_select(1, idx),
                            cfg.max_iterations)
        m.index_copy_(1, idx, packed)
        return m, done + steps

    (M, subcycles), trips = device_while(
        lambda s: s[0][row["itmask"]] > 0, trip, (M, subcycles))
    return _result(cfg, f_const, unpack(M), us, imetal, comoving,
                   subcycles, trips)
