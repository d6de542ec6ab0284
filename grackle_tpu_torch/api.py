"""Public API (port of grackle_tpu/api.py, first slice).

Analogue of the reference's public surface (grackle: src/clib/grackle.h
and the pygrackle ``chemistry_data`` class,
src/python/pygrackle/grackle_wrapper.pyx:22-1051):

* :class:`ChemistryData` — the mutable parameter object with
  pygrackle-compatible attribute and string-keyed access
  (src/clib/dynamic_api.c:35-116), plus code-unit attributes and derived
  unit properties.
* :func:`initialize` builds a :class:`GrackleContext`: rate tables and
  Cloudy tables as tensors on one device in the solver dtype.  Every
  context is an independent value (no globals), so the re-entrant
  ``local_*`` API falls out for free.
* :func:`solve_chemistry` (grackle.h:64).

This slice ports the monolithic solve.  ``solve_path`` names the same
three paths as the JAX package; 'compact' (converged-cell compaction,
used when ``solver_compaction > 0`` and n >= 32768) and 'exact'
(exact-integration tabulated cooling) raise NotImplementedError until
their slices land (ROADMAP queue 1), as do UVB rates, the grid entry
point and the derived fields.  ``use_fused_lookup`` is accepted and has
no effect: the port always gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .config import PARAMETER_REGISTRY, ChemistryConfig, resolve_config
from .data.cloudy import (CloudyTable, empty_cloudy_table, is_old_style,
                          load_cloudy_table)
from .ops import solver as _solver
from .ops.common import (make_unit_scalars, photo_rates_from_tables,
                         solver_dtype)
from .rates.tables import build_rate_tables
from .units import CodeUnits

_COMPACT_MIN_BUCKET = 8192


@dataclasses.dataclass
class GrackleContext:
    """Everything needed to run the solver: the re-entrant analogue of
    (chemistry_data, chemistry_data_storage, code_units)."""

    config: Any  # frozen ChemistryConfig
    units: CodeUnits
    tables: Any
    cloudy_primordial: CloudyTable
    cloudy_metal: CloudyTable
    cloudy_data_new: bool = True
    device: Any = "cpu"


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to grackle_tpu_torch yet (ROADMAP queue 1: "
        f"{item})"
    )


def initialize(cfg: "ChemistryConfig", units: CodeUnits, device="cpu",
               cloudy_data=None) -> GrackleContext:
    """Build rate tables + data tables on ``device`` (analogue of
    initialize_chemistry_data, grackle:
    src/clib/initialize_chemistry_data.c:60-247).

    ``cloudy_data`` is an in-memory table source (data/cloudy.py schema,
    e.g. data/synthetic.synthetic_cloudy_groups()); without it the tables
    are read from ``cfg.grackle_data_file``.
    """
    units.validate()
    cfg = resolve_config(cfg)
    device = torch.device(device)

    cloudy_data_new = True
    read_prim = cfg.primordial_chemistry == 0
    read_met = cfg.metal_cooling == 1
    source = cloudy_data if cloudy_data is not None else \
        cfg.grackle_data_file
    if (read_prim or read_met) and not source:
        raise ValueError(
            "tabulated/metal cooling requires grackle_data_file"
        )
    if read_prim or read_met:
        cloudy_data_new = not is_old_style(source)
    if cfg.UVbackground == 1 and cfg.primordial_chemistry > 0:
        raise _not_ported("UVbackground = 1",
                          "tabulated mode, UVB and exact cooling")

    dtype = solver_dtype(cfg)
    cloudy_prim = (
        load_cloudy_table(source, "Primordial", units,
                          read_heating=cfg.UVbackground == 1,
                          read_mmw=True, device=device, dtype=dtype)
        if read_prim else empty_cloudy_table()
    )
    cloudy_met = (
        load_cloudy_table(source, "Metals", units,
                          read_heating=cfg.UVbackground == 1,
                          read_mmw=False, device=device, dtype=dtype)
        if read_met else empty_cloudy_table()
    )
    tables = build_rate_tables(cfg, units, device=device, dtype=dtype)
    return GrackleContext(
        config=cfg, units=units, tables=tables,
        cloudy_primordial=cloudy_prim, cloudy_metal=cloudy_met,
        cloudy_data_new=cloudy_data_new, device=device,
    )


def solve_path(cfg, n):
    """Which solve implementation a given (config, cell count) uses:
    'exact' | 'compact' | 'monolithic' (the JAX package's rule)."""
    if cfg.exact_cooling == 1 and cfg.with_radiative_cooling == 1:
        return "exact"
    if cfg.solver_compaction > 0 and n >= 4 * _COMPACT_MIN_BUCKET:
        return "compact"
    return "monolithic"


def _prep_fields(ctx, fields):
    """Convert a field dict to solver-dtype tensors on the context's
    device (the gr_float analogue); detect the metal field."""
    dtype = solver_dtype(ctx.config)
    f = {}
    for key, val in fields.items():
        if val is None:
            continue
        if not isinstance(val, torch.Tensor):
            val = torch.as_tensor(np.asarray(val))
        f[key] = val.to(device=ctx.device, dtype=dtype)
    return f, "metal" in f


def sobolev_shield_length(density_grid, xbase1, dx_cgs):
    """Sobolev-like H2-shielding length for H2_self_shielding == 1 from
    the 6-point 3-D density stencil (solve_rate_cool_g.F:1418-1434).
    At a true array edge the missing neighbor is edge-replicated, giving
    diff = 0, which the "only drho/ds < 0 directions" rule excludes."""
    d = density_grid
    dp = torch.nn.functional.pad(d[None, None], (1, 1, 1, 1, 1, 1),
                                 mode="replicate")[0, 0]
    inner = [slice(1, -1)] * 3
    divrho = torch.full_like(d, 1.0e-20)
    for axis in range(3):
        for lo in (False, True):
            sl = list(inner)
            sl[axis] = slice(0, -2) if lo else slice(2, None)
            diff = dp[tuple(sl)] - d
            divrho = divrho + torch.where(diff < 0.0, diff,
                                          torch.zeros_like(diff))
    return torch.clamp(dx_cgs * d / torch.abs(divrho), max=xbase1)


def solve_chemistry(ctx: GrackleContext, fields, dt,
                    grid_dx: float = 0.0, grid_shape=None,
                    l_h2shield=None):
    """Advance chemistry + energy by dt (grackle.h:64, solve_chemistry.c).

    fields: dict of flat arrays or tensors (code units).  Returns
    (new_fields dict of tensors, diagnostics dict with n_iterations,
    converged, cell_iterations and subcycles -- the loop trips run).
    """
    cfg = ctx.config
    f, imetal = _prep_fields(ctx, fields)
    n = f["density"].shape[0] if f["density"].ndim == 1 else 0
    path = solve_path(cfg, n)
    if path == "exact":
        raise _not_ported("the 'exact' solve path (exact_cooling = 1)",
                          "tabulated mode, UVB and exact cooling")
    if path == "compact":
        raise _not_ported(
            "the 'compact' solve path (solver_compaction > 0 at "
            f"n = {n} >= {4 * _COMPACT_MIN_BUCKET}); set "
            "solver_compaction = 0 for the monolithic solve",
            "compaction plus f32 device mode")
    us = make_unit_scalars(cfg, ctx.tables, ctx.units, grid_dx)
    l_h2 = None
    if cfg.H2_self_shielding == 1:
        if l_h2shield is not None:
            l_h2 = torch.as_tensor(l_h2shield).to(
                device=ctx.device, dtype=solver_dtype(cfg)).reshape(-1)
        elif grid_shape is None or len(grid_shape) != 3:
            raise ValueError(
                "H2_self_shielding option 1 requires a 3-D grid_shape "
                "(solve_chemistry.c:157-165); use option 2 to provide "
                "shielding lengths or option 3 for the Jeans length."
            )
        else:
            d_grid = f["density"].reshape(grid_shape)
            l_h2 = sobolev_shield_length(
                d_grid, us.xbase1, us.dx_cgs).reshape(-1)
    pr = photo_rates_from_tables(ctx.tables)
    result = _solver.solve_rate_cool(
        cfg, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal, pr, us,
        f, float(dt), imetal=imetal, cloudy_data_new=ctx.cloudy_data_new,
        l_h2shield_field=l_h2,
        comoving=bool(ctx.units.comoving_coordinates),
    )
    diagnostics = {"n_iterations": result.n_iterations,
                   "converged": result.converged,
                   "cell_iterations": result.cell_iterations,
                   "subcycles": result.subcycles}
    if cfg.exit_after_iterations_exceeded:
        # analogue of the reference's hard failure when the subcycle cap
        # is hit (solve_rate_cool_g.F:823-843 honoring exititmax)
        if not bool(result.converged.all()):
            raise RuntimeError(
                f"solve_chemistry: iteration count exceeded "
                f"max_iterations = {cfg.max_iterations} before all cells "
                f"reached dt."
            )
    return result.fields, diagnostics


class ChemistryData:
    """pygrackle-compatible parameter object.

    Set parameters as attributes (or string keys), set the unit attributes,
    then call :meth:`initialize`.  After initialization
    :meth:`solve_chemistry` is live.  (grackle:
    src/python/pygrackle/grackle_wrapper.pyx:22-96,943-1051)
    """

    def __init__(self, **kwargs):
        object.__setattr__(self, "_params", {
            name: default for name, (_, default) in
            PARAMETER_REGISTRY.items()
        })
        object.__setattr__(self, "_units", {
            "comoving_coordinates": 0,
            "density_units": 1.0,
            "length_units": 1.0,
            "time_units": 1.0,
            "a_units": 1.0,
            "a_value": 1.0,
        })
        object.__setattr__(self, "_context", None)
        for key, val in kwargs.items():
            setattr(self, key, val)

    # --- attribute access routed through the registry
    #     (dynamic_api.c analogue) ---

    def __getattr__(self, name):
        params = object.__getattribute__(self, "_params")
        units = object.__getattribute__(self, "_units")
        if name in params:
            return params[name]
        if name in units:
            return units[name]
        # rate-table views after initialize, like pygrackle's read-only
        # NumPy views of k1..k58 / cooling coefficient tables
        # (grackle_wrapper.pyx:98-549)
        ctx = object.__getattribute__(self, "_context")
        if (ctx is not None and not name.startswith("_")
                and hasattr(ctx.tables, name)):
            val = getattr(ctx.tables, name)
            if val is not None:
                view = np.array(val.cpu() if isinstance(val, torch.Tensor)
                                else val)
                view.flags.writeable = False
                return view
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._params:
            ptype = PARAMETER_REGISTRY[name][0]
            self._params[name] = ptype(value)
        elif name in self._units:
            self._units[name] = value
        else:
            raise AttributeError(
                f"unknown chemistry_data attribute: {name}"
            )

    # string-keyed dynamic API (dynamic_api.c:35-116)
    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, value):
        setattr(self, key, value)

    def parameter_names(self):
        return list(self._params)

    # --- units ---

    @property
    def code_units(self) -> CodeUnits:
        return CodeUnits(**self._units)

    @property
    def velocity_units(self):
        return self.code_units.velocity_units

    @property
    def temperature_units(self):
        return self.code_units.temperature_units

    @property
    def energy_units(self):
        return self.code_units.energy_units

    @property
    def pressure_units(self):
        return self.code_units.pressure_units

    @property
    def cooling_units(self):
        return self.code_units.coolunit

    # --- lifecycle ---

    def initialize(self, device="cpu", cloudy_data=None) -> int:
        """Build the context on ``device``; ``cloudy_data`` as in
        :func:`initialize`."""
        ctx = initialize(ChemistryConfig(**self._params), self.code_units,
                         device=device, cloudy_data=cloudy_data)
        object.__setattr__(self, "_context", ctx)
        # propagate derived parameter values back (e.g. tabulated-mode
        # HydrogenFractionByMass, photoelectric_heating resolution)
        for name in self._params:
            self._params[name] = getattr(ctx.config, name)
        return 1

    @property
    def config(self) -> "ChemistryConfig":
        """The frozen parameter struct (the resolved one after
        initialize())."""
        if self._context is not None:
            return self._context.config
        return ChemistryConfig(**self._params)

    @property
    def context(self) -> Optional[GrackleContext]:
        return self._context

    def refresh_units(self):
        """Rebuild the context units view after unit attributes change
        (e.g. a_value updates in a cosmological run)."""
        if self._context is not None:
            self._context.units = self.code_units

    def _require_context(self):
        if self._context is None:
            raise RuntimeError(
                "chemistry_data not initialized; call initialize()"
            )
        self.refresh_units()
        return self._context

    def solve_chemistry(self, fields, dt, grid_dx=0.0, grid_shape=None,
                        l_h2shield=None):
        return solve_chemistry(self._require_context(), fields, dt,
                               grid_dx, grid_shape, l_h2shield)

    def solve_chemistry_grid(self, *args, **kwargs):
        raise _not_ported("solve_chemistry_grid",
                          "derived fields and the grid API")

    def _derived(self, name):
        raise _not_ported(name, "derived fields and the grid API")

    def calculate_cooling_time(self, fields):
        self._derived("calculate_cooling_time")

    def calculate_temperature(self, fields):
        self._derived("calculate_temperature")

    def calculate_pressure(self, fields):
        self._derived("calculate_pressure")

    def calculate_gamma(self, fields):
        self._derived("calculate_gamma")

    def calculate_dust_temperature(self, fields):
        self._derived("calculate_dust_temperature")
