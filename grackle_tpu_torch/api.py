"""Public API (port of grackle_tpu/api.py).

Analogue of the reference's public surface (grackle: src/clib/grackle.h
and the pygrackle ``chemistry_data`` class,
src/python/pygrackle/grackle_wrapper.pyx:22-1051):

* :class:`ChemistryData` — the mutable parameter object with
  pygrackle-compatible attribute and string-keyed access
  (src/clib/dynamic_api.c:35-116), plus code-unit attributes and derived
  unit properties.
* :func:`initialize` builds a :class:`GrackleContext`: rate tables, Cloudy
  tables and the UVB table, with tensors on one device in the solver
  dtype.  The device is the CUDA card unless the caller passes
  ``device="cpu"``; without a card that call raises, it never falls back.
  Every context is an independent value (no globals), so the re-entrant
  ``local_*`` API falls out for free.
* :func:`solve_chemistry` (grackle.h:64), :func:`solve_chemistry_grid`,
  and the derived fields ``calculate_cooling_time``,
  ``calculate_temperature``, ``calculate_pressure``, ``calculate_gamma``
  and ``calculate_dust_temperature`` (grackle.h:52-102).

``solve_path`` names the same three paths as the JAX package: 'compact'
(converged-cell compaction, used when ``solver_compaction > 0`` and
n >= 32768), 'monolithic', and 'exact' (exact-integration tabulated
cooling), which raises NotImplementedError until its slice lands (ROADMAP
queue 1).  ``use_fused_lookup`` is accepted and has no effect: the port
always gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .config import PARAMETER_REGISTRY, ChemistryConfig, resolve_config
from .data.cloudy import (CloudyTable, empty_cloudy_table, is_old_style,
                          load_cloudy_table)
from .data.uvb import load_uvb_table, update_uvb_rates, uvb_redshift_bounds
from .ops import derived as _derived
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
    uvb: Any = None  # data/uvb.UVBTable on the host, or None
    cloudy_data_new: bool = True
    device: Any = "cuda"


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to grackle_tpu_torch yet (ROADMAP queue 1: "
        f"{item})"
    )


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for another.  Raises, naming ``device="cpu"``, when a CUDA device
    is asked for and there is none; never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "grackle_tpu_torch runs on a CUDA device by default and this "
            "machine has none; pass device=\"cpu\" to run on the CPU"
        )
    return device


def initialize(cfg: "ChemistryConfig", units: CodeUnits, device="cuda",
               cloudy_data=None) -> GrackleContext:
    """Build rate tables + data tables on ``device`` (analogue of
    initialize_chemistry_data, grackle:
    src/clib/initialize_chemistry_data.c:60-247).

    ``cloudy_data`` is an in-memory table source (data/cloudy.py and
    data/uvb.py layouts, e.g. data/synthetic.synthetic_cloudy_groups());
    without it the tables are read from ``cfg.grackle_data_file``.
    """
    units.validate()
    cfg = resolve_config(cfg)
    device = resolve_device(device)

    cloudy_data_new = True
    read_prim = cfg.primordial_chemistry == 0
    read_met = cfg.metal_cooling == 1
    read_uvb = cfg.UVbackground == 1 and cfg.primordial_chemistry > 0
    source = cloudy_data if cloudy_data is not None else \
        cfg.grackle_data_file
    if (read_prim or read_met) and not source:
        raise ValueError(
            "tabulated/metal cooling requires grackle_data_file"
        )
    if read_uvb and not source:
        raise ValueError("UVbackground = 1 requires grackle_data_file")
    if read_prim or read_met:
        cloudy_data_new = not is_old_style(source)

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
    uvb = None
    if read_uvb:
        uvb = load_uvb_table(source, cfg)
        updates = uvb_redshift_bounds(cfg, uvb)
        if updates:
            cfg = dataclasses.replace(cfg, **updates)
    tables = build_rate_tables(cfg, units, device=device, dtype=dtype)
    return GrackleContext(
        config=cfg, units=units, tables=tables,
        cloudy_primordial=cloudy_prim, cloudy_metal=cloudy_met, uvb=uvb,
        cloudy_data_new=cloudy_data_new, device=device,
    )


def _photo_rates(cfg, tables, uvb, units):
    """solve_chemistry.c:103-137: the UVB rates at this call's redshift,
    else the constant rates of the tables."""
    if cfg.UVbackground == 1 and uvb is not None:
        return update_uvb_rates(cfg, uvb, units)
    return photo_rates_from_tables(tables)


def solve_path(cfg, n):
    """Which solve implementation a given (config, cell count) uses:
    'exact' | 'compact' | 'monolithic' (the JAX package's rule)."""
    if cfg.exact_cooling == 1 and cfg.with_radiative_cooling == 1:
        return "exact"
    if cfg.solver_compaction > 0 and n >= 4 * _COMPACT_MIN_BUCKET:
        return "compact"
    return "monolithic"


def _compact_batch(n):
    """The compacted solve's batch: 81,920 cells, clamped to n/4 and
    floored at _COMPACT_MIN_BUCKET (the JAX package's default, tuned on a
    TPU; its GTPU_COMPACT_BATCH override is not carried over)."""
    return max(_COMPACT_MIN_BUCKET, min(81920, n // 4))


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
    converged, cell_iterations, subcycles -- the subcycles run, that is
    the network launches -- and trips, the compacted solve's batches).

    l_h2shield: optional precomputed per-cell shielding length (cgs) for
    H2_self_shielding == 1, which :func:`solve_chemistry_grid` computes
    on the full grid, ghost zones included.
    """
    cfg = ctx.config
    f, imetal = _prep_fields(ctx, fields)
    n = f["density"].shape[0] if f["density"].ndim == 1 else 0
    path = solve_path(cfg, n)
    if path == "exact":
        raise _not_ported("the 'exact' solve path (exact_cooling = 1)",
                          "exact cooling")
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
    # unit scalars and UVB photo rates are per-call host work, as the
    # reference computes them in C per call
    pr = _photo_rates(cfg, ctx.tables, ctx.uvb, ctx.units)
    args = (cfg, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal, pr,
            us, f, float(dt))
    kw = dict(imetal=imetal, cloudy_data_new=ctx.cloudy_data_new,
              l_h2shield_field=l_h2,
              comoving=bool(ctx.units.comoving_coordinates))
    if path == "compact":
        # solver_compaction is the warm phase's subcycle count
        result = _solver.solve_rate_cool_compacted(
            *args, **kw, warm=int(cfg.solver_compaction),
            batch=_compact_batch(n))
    else:
        result = _solver.solve_rate_cool(*args, **kw)
    diagnostics = {"n_iterations": result.n_iterations,
                   "converged": result.converged,
                   "cell_iterations": result.cell_iterations,
                   "subcycles": result.subcycles,
                   "trips": result.trips}
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


def _host(val):
    return val.cpu().numpy() if isinstance(val, torch.Tensor) \
        else np.asarray(val)


def solve_chemistry_grid(ctx: GrackleContext, fields, dt,
                         grid_start=None, grid_end=None,
                         grid_dx: float = 0.0):
    """solve_chemistry for multi-dimensional grids with ghost zones.

    fields: dict of arrays of a common grid shape (any rank).  Only the
    active region [grid_start, grid_end] (inclusive, per axis — the
    reference's convention, grackle: grackle_types.h:44-46) is evolved;
    ghost zones pass through untouched.  H2_self_shielding == 1 takes the
    density stencil on the full grid, ghost zones included, as the
    reference does (solve_rate_cool_g.F:1420-1434).  Returns (dict of
    NumPy grids, diagnostics).
    """
    host = {key: _host(val) for key, val in fields.items()
            if val is not None}
    shape = next(iter(host.values())).shape
    rank = len(shape)
    if grid_start is None:
        grid_start = [0] * rank
    if grid_end is None:
        grid_end = [s - 1 for s in shape]
    sl = tuple(slice(s, e + 1) for s, e in zip(grid_start, grid_end))
    flat = {key: val[sl].reshape(-1) for key, val in host.items()}

    l_h2 = None
    if ctx.config.H2_self_shielding == 1:
        if rank != 3:
            raise ValueError(
                "H2_self_shielding option 1 requires 3-D grids"
            )
        us = make_unit_scalars(ctx.config, ctx.tables, ctx.units, grid_dx)
        d_full = torch.as_tensor(host["density"]).to(ctx.device)
        l_h2 = sobolev_shield_length(
            d_full, us.xbase1, us.dx_cgs)[sl].reshape(-1)
    new_flat, diag = solve_chemistry(ctx, flat, dt, grid_dx,
                                     l_h2shield=l_h2)

    out = {}
    for key, val in host.items():
        arr = np.array(val)
        if key in new_flat:
            arr[sl] = _host(new_flat[key]).astype(arr.dtype).reshape(
                arr[sl].shape)
        out[key] = arr
    return out, diag


def calculate_cooling_time(ctx: GrackleContext, fields):
    f, imetal = _prep_fields(ctx, fields)
    us = make_unit_scalars(ctx.config, ctx.tables, ctx.units)
    pr = _photo_rates(ctx.config, ctx.tables, ctx.uvb, ctx.units)
    return _derived.calculate_cooling_time(
        ctx.config, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal,
        pr, us, f, imetal=imetal, cloudy_data_new=ctx.cloudy_data_new,
        comoving=bool(ctx.units.comoving_coordinates),
    )


def calculate_temperature(ctx: GrackleContext, fields):
    f, imetal = _prep_fields(ctx, fields)
    us = make_unit_scalars(ctx.config, ctx.tables, ctx.units)
    return _derived.calculate_temperature(ctx.config, ctx.cloudy_primordial,
                                          us, f, imetal)


def calculate_pressure(ctx: GrackleContext, fields):
    f, imetal = _prep_fields(ctx, fields)
    us = make_unit_scalars(ctx.config, ctx.tables, ctx.units)
    return _derived.calculate_pressure(ctx.config, us, f, imetal)


def calculate_gamma(ctx: GrackleContext, fields):
    f, imetal = _prep_fields(ctx, fields)
    us = make_unit_scalars(ctx.config, ctx.tables, ctx.units)
    return _derived.calculate_gamma(ctx.config, ctx.cloudy_primordial, us,
                                    f, imetal)


def calculate_dust_temperature(ctx: GrackleContext, fields):
    f, imetal = _prep_fields(ctx, fields)
    us = make_unit_scalars(ctx.config, ctx.tables, ctx.units)
    return _derived.calculate_dust_temperature(
        ctx.config, ctx.tables, ctx.cloudy_primordial, us, f, ctx.units,
        imetal,
    )


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

    def initialize(self, device="cuda", cloudy_data=None) -> int:
        """Build the context on ``device`` (the CUDA card unless
        ``device="cpu"``); ``cloudy_data`` as in :func:`initialize`."""
        ctx = initialize(ChemistryConfig(**self._params), self.code_units,
                         device=device, cloudy_data=cloudy_data)
        object.__setattr__(self, "_context", ctx)
        # propagate derived parameter values back (e.g. tabulated-mode
        # HydrogenFractionByMass, the UVB redshift bounds)
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

    def solve_chemistry_grid(self, fields, dt, grid_start=None,
                             grid_end=None, grid_dx=0.0):
        return solve_chemistry_grid(self._require_context(), fields, dt,
                                    grid_start, grid_end, grid_dx)

    def calculate_cooling_time(self, fields):
        return calculate_cooling_time(self._require_context(), fields)

    def calculate_temperature(self, fields):
        return calculate_temperature(self._require_context(), fields)

    def calculate_pressure(self, fields):
        return calculate_pressure(self._require_context(), fields)

    def calculate_gamma(self, fields):
        return calculate_gamma(self._require_context(), fields)

    def calculate_dust_temperature(self, fields):
        return calculate_dust_temperature(self._require_context(), fields)
