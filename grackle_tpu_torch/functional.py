"""Functional entry points: closures over an initialized context (port of
grackle_tpu/functional.py).

The reference is a C library a hydro code calls once per timestep
(grackle: src/clib/solve_chemistry.c:91-370).  These factories do that
call's per-call host work once, when the closure is built, and return
plain functions of the fields:

    import grackle_tpu_torch.functional as gfn
    solve = gfn.make_solve_fn(chem)          # chem: initialized ChemistryData
    temperature = gfn.make_temperature_fn(chem)

    for step in range(n_steps):
        fields, diag = solve(fields, dt)

What is frozen at build time (host-side, like the reference's per-call C
work, update_UVbackground_rates.c:25-289): the parameter set, the rate
tables, the unit system, and the redshift-dependent UV-background photo
rates, the last two as one scalar block on the context's device
(api.call_scalars), which the closure's body reads as the stateful
calls' bodies read theirs.  For cosmological runs rebuild the closure
when ``a_value`` changes; for constant-a runs nothing ever needs
rebuilding.

What holds, as the JAX package's closures are "trace-safe": a call reads
nothing on the host but its loops' exit checks, and inside a CUDA-graph
capture not even those.  The solve's loops (the subcycle loop, the
compacted solve's trips, the dust-temperature Newton and bisection
solves, the tabulated-mode temperature fixed point) go through
``ops/device_loop.device_while``: called eagerly, each reads "some cell
active" once a block of steps; called while the current stream captures
a ``torch.cuda.CUDAGraph``, each becomes a conditional WHILE node whose
condition a kernel sets on the device.  ``dt`` may be a 0-d tensor on
the fields' device, so one graph serves every timestep: a hydro code
captures its whole step, the chemistry in it, and replays it.

The contract: run the step once eagerly first (that call builds the
kernels and sets up CUDA state), then capture it; a replay reads its
inputs from the tensors the capture saw and writes the same output
tensors, bit-identical to an eager call on the same inputs.  Each
graph's loop bodies allocate from a memory pool of its own, held until
the graph is destroyed, so graphs may replay at the same time on
different streams.  The derived-field closures come under the same
contract.

    solve = gfn.make_solve_fn(chem)
    dt = torch.tensor(1.0e-4, dtype=torch.float64, device="cuda")
    fields = {k: v.cuda() for k, v in fields.items()}   # static inputs
    solve(fields, dt)                                    # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new_fields, diag = solve(fields, dt)
        floor = torch.minimum(new_fields["energy"], fields["energy"])
    for step in range(n_steps):
        graph.replay()                   # new_fields, diag, floor
        for k in fields:                 # the next step's input
            fields[k].copy_(new_fields[k])
        dt.fill_(next_dt)                # or any device-side update

Each closure gives, for the same context, results identical to
``ChemistryData.solve_chemistry`` and ``calculate_*`` bit for bit: they
run the same functions on the same unit scalars and photo rates.  Every
``diag`` entry of the solve closure is a tensor.
The derived-field closures are differentiable with ``torch.autograd``
with respect to the field tensors passed in (tests/test_torch_functional).

Differences from the stateful API (``ChemistryData.solve_chemistry``), as
in the JAX package:

- ``exit_after_iterations_exceeded`` does not raise; inspect
  ``diag["converged"]`` instead.
- Field arrays must already be flat ``[N]`` (ravel grids yourself; ghost
  -zone slicing is a host-side concern).
- H2_self_shielding option 1 (the 3-D density stencil) takes the
  precomputed per-cell length via the ``l_h2shield`` argument --
  compute it with ``grackle_tpu_torch.api.sobolev_shield_length`` on the
  full grid.
"""

from __future__ import annotations

import torch

from .api import (
    GrackleContext,
    _prep_fields,
    call_scalars,
    shield_length_tensor,
    solve_prepared,
)
from .ops import derived as _derived
from .ops.common import block_scalars

__all__ = [
    "make_solve_fn",
    "make_cooling_time_fn",
    "make_temperature_fn",
    "make_pressure_fn",
    "make_gamma_fn",
    "make_dust_temperature_fn",
]


def _resolve_ctx(chem) -> GrackleContext:
    if isinstance(chem, GrackleContext):
        return chem
    ctx = getattr(chem, "context", None)
    if ctx is None:
        raise ValueError(
            "make_*_fn expects an initialized ChemistryData (call "
            ".initialize() first) or a GrackleContext"
        )
    return ctx


def _scalars(ctx, grid_dx=0.0):
    """The closure's scalars, fixed at build time as the JAX closures'
    are (grackle_tpu/functional.py:20-28): one block on the context's
    device, as (UnitScalars, PhotoRates, BodyUnits) of 0-d views."""
    return block_scalars(call_scalars(ctx, ctx.device, grid_dx=grid_dx))


def make_solve_fn(chem, grid_dx: float = 0.0):
    """Build ``solve(fields, dt, l_h2shield=None) -> (fields, diag)``.

    ``dt`` is a float or a 0-d tensor on the fields' device; the solve
    reads it in float64 either way.  ``diag`` holds tensors:
    n_iterations, converged, cell_iterations, subcycles (the network
    launches) and trips (the compacted solve's batches).

    Path selection (exact-integration cooling / converged-cell
    compaction / monolithic subcycling) is the stateful API's
    (api.solve_path), so results are identical to
    ``ChemistryData.solve_chemistry`` for the same context.
    """
    ctx = _resolve_ctx(chem)
    cfg = ctx.config
    us, pr, _ = _scalars(ctx, grid_dx)

    def solve(fields, dt, l_h2shield=None):
        f, imetal = _prep_fields(ctx, fields)
        if cfg.H2_self_shielding == 1 and l_h2shield is None:
            raise ValueError(
                "H2_self_shielding option 1 requires the precomputed "
                "per-cell shielding length: solve(fields, dt, "
                "l_h2shield=...) -- see api.sobolev_shield_length"
            )
        l_h2 = (None if l_h2shield is None
                else shield_length_tensor(ctx, l_h2shield))
        new_f, diag = solve_prepared(ctx, us, pr, f, dt, imetal, l_h2)
        device = f["density"].device
        return new_f, {
            key: val if isinstance(val, torch.Tensor) else
            torch.full((), val, dtype=torch.int64, device=device)
            for key, val in diag.items()}

    return solve


def make_cooling_time_fn(chem):
    """Build ``cooling_time(fields) -> [N]`` (calculate_cooling_time.c)."""
    ctx = _resolve_ctx(chem)
    cfg = ctx.config
    us, pr, _ = _scalars(ctx)
    comoving = bool(ctx.units.comoving_coordinates)

    def cooling_time(fields):
        f, imetal = _prep_fields(ctx, fields)
        return _derived.calculate_cooling_time(
            cfg, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal,
            pr, us, f, imetal=imetal,
            cloudy_data_new=ctx.cloudy_data_new, comoving=comoving,
        )

    return cooling_time


def make_temperature_fn(chem):
    """Build ``temperature(fields) -> [N]`` (calculate_temperature.c)."""
    ctx = _resolve_ctx(chem)
    us, _, _ = _scalars(ctx)

    def temperature(fields):
        f, imetal = _prep_fields(ctx, fields)
        return _derived.calculate_temperature(
            ctx.config, ctx.cloudy_primordial, us, f, imetal)

    return temperature


def make_pressure_fn(chem):
    """Build ``pressure(fields) -> [N]`` (calculate_pressure.c)."""
    ctx = _resolve_ctx(chem)
    us, _, _ = _scalars(ctx)

    def pressure(fields):
        f, imetal = _prep_fields(ctx, fields)
        return _derived.calculate_pressure(ctx.config, us, f, imetal)

    return pressure


def make_gamma_fn(chem):
    """Build ``gamma(fields) -> [N]`` (calculate_gamma.c)."""
    ctx = _resolve_ctx(chem)
    us, _, _ = _scalars(ctx)

    def gamma(fields):
        f, imetal = _prep_fields(ctx, fields)
        return _derived.calculate_gamma(
            ctx.config, ctx.cloudy_primordial, us, f, imetal)

    return gamma


def make_dust_temperature_fn(chem):
    """Build ``dust_temperature(fields) -> [N]``
    (calculate_dust_temperature.c)."""
    ctx = _resolve_ctx(chem)
    us, _, units = _scalars(ctx)

    def dust_temperature(fields):
        f, imetal = _prep_fields(ctx, fields)
        return _derived.calculate_dust_temperature(
            ctx.config, ctx.tables, ctx.cloudy_primordial, us, f, units,
            imetal)

    return dust_temperature
