"""grackle_tpu_torch's exact-integration tabulated cooling against
grackle_tpu: the row forms of ops/interp.py, ``exact_cool_step`` on the
analytic constant-Lambda table and on the synthetic rank-3 table, and the
stateful 'exact' solve path.

The same seeded numpy state goes through the JAX function (under one
jax.jit, on the CPU) and its port, both in f64, on identical tables.  The tolerance is
rtol 1e-10: the two packages' log, exp and pow (two libms) differ by an
ulp or two, and the per-segment power laws carry that through a few
dozen operations (the largest difference seen is 2e-12).  The exact path
is also held against the port's own subcycled solve at the bounds of
tests/test_exact_cooling.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu.config import default_config as jdefault_config
from grackle_tpu.config import resolve_config as jresolve_config
from grackle_tpu.data.cloudy import CloudyTable as JCloudyTable
from grackle_tpu.ops import common as jcommon
from grackle_tpu.ops import exact_cool as jexact
from grackle_tpu.ops import interp as jinterp
from grackle_tpu.ops import lookup as jlookup
from grackle_tpu.rates.tables import build_rate_tables as jbuild
from grackle_tpu.units import CodeUnits as JCodeUnits
from grackle_tpu_torch import api
from grackle_tpu_torch.config import default_config, resolve_config
from grackle_tpu_torch.data.cloudy import CloudyTable
from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
from grackle_tpu_torch.ops import exact_cool, interp
from grackle_tpu_torch.ops.common import (block_scalars, make_unit_scalars,
                                          photo_rates_from_tables,
                                          scalar_block)
from grackle_tpu_torch.rates.tables import build_rate_tables
from grackle_tpu_torch.units import CodeUnits
from tests.test_torch_derived import _jax_chem
from tests.test_torch_network import UNIT_ATTRS, jax_context_as_port

torch.set_num_threads(1)

RTOL = 1e-10


def _close(got, want, rtol=RTOL, name="", atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=name)


def _rounding(got, want, name):
    """Agreement to f64 rounding of the table's magnitude: the JAX f64
    rows come through an f32 split fetch, exact to about an ulp of the
    table values, and extrapolated rows can pass through zero."""
    want = np.asarray(want)
    _close(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max(),
           name=name)


#: rows_at_scalar_temperature's abscissae: below, inside and above the
#: temperature grid
SCALAR_T = (0.3, 2.7, 9.9)


def test_row_forms_match():
    """temperature_rows (ranks 1-3, redshift inside and past the table),
    rows_at_temperature and rows_at_scalar_temperature, with abscissae
    beyond the grid ends (extrapolation), in f64, to rounding.  The JAX
    forms run under one jax.jit per case."""
    rng = np.random.RandomState(5)
    n = 200
    par1 = np.linspace(-10.0, 4.0, 25)
    par2 = np.linspace(0.0, 10.0, 10)
    par3 = np.linspace(1.0, 9.0, 121)
    data3 = rng.uniform(-30, -20, (25, 10, 121))
    x1 = rng.uniform(-12.0, 6.0, n)
    xt = rng.uniform(0.5, 9.5, n)
    cases = {1: ([par3], data3[2, 3]), 2: ([par1, par3], data3[:, 1]),
             3: ([par1, par2, par3], data3)}
    for rank, (pars, data) in cases.items():
        par_t = pars[-1]
        for zr in ((0.0, 4.4, 9.5) if rank == 3 else (0.0,)):
            pt = CloudyTable(grid_rank=rank, grid_dimension=data.shape,
                             **{f"par{i + 1}": torch.from_numpy(p)
                                for i, p in enumerate(pars)})
            # the port reads the call's scalars as 0-d tensors
            zr_t = torch.tensor(zr, dtype=torch.float64)
            pz = (interp.redshift_index(zr_t, pt.par2, 10) if rank == 3
                  else (None, None))
            rows = interp.temperature_rows(pt, torch.from_numpy(data),
                                           torch.from_numpy(x1), zr_t, *pz)
            got = [rows, interp.rows_at_temperature(
                rows, torch.from_numpy(par_t), torch.from_numpy(xt))]
            got += [interp.rows_at_scalar_temperature(
                rows, torch.from_numpy(par_t),
                torch.tensor(x, dtype=torch.float64)) for x in SCALAR_T]

            @jax.jit
            def jax_forms(data, x1, xt, pars, zr=zr, rank=rank):
                jt = JCloudyTable(grid_rank=rank, grid_dimension=data.shape,
                                  **{f"par{i + 1}": p
                                     for i, p in enumerate(pars)})
                jz = (jinterp.redshift_index(zr, jt.par2, 10) if rank == 3
                      else (None, None))
                rows = jinterp.temperature_rows(jt, data, x1, zr, *jz,
                                                jnp.float64)
                return [rows, jinterp.rows_at_temperature(rows, pars[-1],
                                                          xt)] + [
                    jinterp.rows_at_scalar_temperature(
                        rows, pars[-1], jnp.float64(x)) for x in SCALAR_T]

            want = jax_forms(jnp.asarray(data), jnp.asarray(x1),
                             jnp.asarray(xt), [jnp.asarray(p) for p in pars])
            # log(1+z) from two libms on the redshift axis
            for name, g, w in zip(
                    ["temperature_rows", "rows_at_temperature"]
                    + [f"rows_at_scalar_temperature {x}" for x in SCALAR_T],
                    got, want):
                _rounding(g, w, f"rank {rank} z {zr} {name}")


def _running_cumsum(x, axis):
    """A prefix sum along ``axis`` added in order, as PyTorch's and
    numpy's CPU cumsum add (jnp.cumsum's window reduction adds in another
    order); traceable."""
    def add(total, column):
        total = total + column
        return total, total

    cols = jnp.moveaxis(x, axis, 0)
    _, out = jax.lax.scan(add, jnp.zeros_like(cols[0]), cols)
    return jnp.moveaxis(out, 0, axis)


def jax_exact_step(cfg, prim, met, pr, us, imetal, running=False):
    """The JAX package's exact_cool_step as one jitted function of
    (fields, dt), with its prefix sum in order when ``running``: one
    compile, where eager JAX compiles each of its primitives."""
    def step(f, dt):
        with pytest.MonkeyPatch.context() as mp:
            if running:
                mp.setattr(jexact.jnp, "cumsum", _running_cumsum)
            return jexact.exact_cool_step(cfg, prim, met, pr, us, f, dt,
                                          imetal)

    return jax.jit(step)


def _units_kw():
    return dict(comoving_coordinates=0, a_units=1.0, a_value=1.0,
                **UNIT_ATTRS)


def test_constant_lambda_matches_analytic_and_jax(monkeypatch):
    """A rank-1 table with constant cooling and constant mmw: e(t) = e0 -
    rate * t (tests/test_exact_cooling.py:51-100), and the JAX package's
    step on the same inputs."""
    # the f32 splits of the fused TPU lookup are unused on the gather path
    monkeypatch.setattr(jlookup, "pair_split", lambda mat: None)
    opts = dict(use_grackle=1, with_radiative_cooling=1,
                primordial_chemistry=0, metal_cooling=0, exact_cooling=1,
                precision=64)
    cfg = resolve_config(default_config(**opts))
    jcfg = jresolve_config(jdefault_config(**opts))
    units, junits = CodeUnits(**_units_kw()), JCodeUnits(**_units_kw())
    tables = build_rate_tables(cfg, units)
    host_us = make_unit_scalars(cfg, tables, units, 0.0)
    us, pr, _ = block_scalars(scalar_block(
        cfg, "cpu", host_us, photo_rates_from_tables(tables), units))
    jtables = jbuild(jcfg, junits, dtype=jnp.float64)
    jus = jcommon.make_unit_scalars(jcfg, jtables, junits, 0.0)
    jpr = jcommon.photo_rates_from_tables(jtables)

    K = 41
    arrays = dict(par1=np.linspace(1.0, 9.0, K), cooling=np.full(K, -2.0),
                  mmw=np.full(K, 0.6))
    prim = CloudyTable(grid_rank=1, grid_dimension=(K,),
                       **{k: torch.from_numpy(v) for k, v in arrays.items()})
    jprim = JCloudyTable(grid_rank=1, grid_dimension=(K,),
                         **{k: jnp.asarray(v) for k, v in arrays.items()})

    n = 64
    rng = np.random.RandomState(2)
    d = 10.0 ** rng.uniform(-1, 2, n)
    T0 = 10.0 ** rng.uniform(5.0, 7.0, n)
    e0 = T0 / ((cfg.Gamma - 1.0) * 0.6 * host_us.utem)
    dt = 1.0e-3
    got = exact_cool.exact_cool_step(
        cfg, prim, CloudyTable(grid_rank=0, grid_dimension=()), pr, us,
        {"density": torch.from_numpy(d), "energy": torch.from_numpy(e0)},
        dt, imetal=False)
    want = jax_exact_step(
        jcfg, jprim, JCloudyTable(grid_rank=0, grid_dimension=()), jpr,
        jus, imetal=False)(
        {"density": jnp.asarray(d), "energy": jnp.asarray(e0)}, dt)
    _close(got, want)
    rhoH = cfg.HydrogenFractionByMass * d
    _close(got, e0 - 10.0 ** -2.0 * rhoH * rhoH / d * dt, rtol=2e-3)
    assert bool((got < torch.from_numpy(e0)).all())


@functools.lru_cache(maxsize=None)
def _tab_contexts(metal, comoving=False):
    """(JAX ChemistryData, port context) of the tabulated exact path on
    the synthetic data file, built once per test process."""
    kw = dict(primordial_chemistry=0, metal_cooling=int(metal),
              exact_cooling=1)
    if comoving:
        kw.update(comoving_coordinates=1, a_units=1.0, a_value=0.5)
    jcd = _jax_chem(**kw)
    return jcd, jax_context_as_port(jcd)


@pytest.mark.parametrize("metal", [False, True])
def test_exact_cool_step_matches_jax(metal):
    """The synthetic rank-3 table (redshift 0), with and without the
    resampled metal table and its CMB floor, at a dt that moves few cells
    (3e-5), most cells (1e-3) and every cell down to the floor (0.3).

    The JAX package's prefix sum is XLA's window reduction, which sums in
    another order than a running sum (PyTorch's and numpy's).  Without
    metal cooling, the primordial table's floor makes the low segments'
    crossing times so long that the prefix times above them keep few
    significant digits of the short segments, and the energy of a cell
    that descends through them carries that order (up to 9e-5 relative
    at dt >= 1e-3).  So the JAX step runs with a running sum here, and
    the unchanged JAX step is compared where the order does not show."""
    jcd, ctx = _tab_contexts(metal)
    jctx = jcd.context
    f = chip_smoke.tabulated_state(jcd, 256, metal)
    us, pr, _ = block_scalars(api.call_scalars(ctx, "cpu"))
    jax_step = {running: jax_exact_step(
        jctx.config, jctx.cloudy_primordial, jctx.cloudy_metal,
        jcommon.photo_rates_from_tables(jctx.tables),
        jcommon.make_unit_scalars(jctx.config, jctx.tables, jctx.units),
        metal, running) for running in (False, True)}
    for dt, running in ((3.0e-5, False), (3.0e-5, True), (1.0e-3, True),
                        (0.3, True)):
        got = exact_cool.exact_cool_step(
            ctx.config, ctx.cloudy_primordial, ctx.cloudy_metal, pr, us,
            {k: torch.from_numpy(v) for k, v in f.items()}, dt, metal)
        want = jax_step[running]({k: jnp.asarray(v) for k, v in f.items()},
                                 dt)
        _close(got, want, name=f"dt {dt}")
        assert bool((got <= torch.from_numpy(f["energy"])).all())
        if dt == 0.3:
            assert bool((got < torch.from_numpy(f["energy"])).all())


@pytest.mark.parametrize("comoving", [False, True])
def test_exact_solve_matches_jax(comoving):
    """The stateful path: comoving fields scaled to proper first, only
    the energy replaced, and the JAX package's diagnostics plus zero
    subcycles and trips (no network launch)."""
    jcd, ctx = _tab_contexts(True, comoving)
    assert api.solve_path(ctx.config, 128) == "exact"
    f = chip_smoke.tabulated_state(jcd, 128)
    want, jdiag = jcd.solve_chemistry(dict(f), 0.5)
    got, diag = api.solve_chemistry(ctx, f, 0.5)
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "energy":
            _close(got[key], want[key], name=key)
        else:
            assert torch.equal(got[key], torch.from_numpy(f[key])), key
    assert diag["subcycles"] == 0 and diag["trips"] == 0
    assert int(diag["n_iterations"]) == int(jdiag["n_iterations"]) == 1
    assert bool(diag["converged"].all())
    assert torch.equal(diag["cell_iterations"],
                       torch.ones(128, dtype=torch.int32))


@pytest.mark.parametrize("metal", [False, True])
def test_exact_vs_subcycled(metal):
    """The exact step against the port's subcycled tabulated solve at a
    small dt: both approximate the same ODE, within the bounds of
    tests/test_exact_cooling.py:137-141."""
    exact_cd, sub_cd = (chip_smoke.answer_chem(
        "cpu", primordial_chemistry=0, metal_cooling=int(metal),
        exact_cooling=exact) for exact in (1, 0))
    f = chip_smoke.tabulated_state(exact_cd, 256, metal)
    exact, _ = exact_cd.solve_chemistry(f, 3.0e-5)
    step, diag = sub_cd.solve_chemistry(f, 3.0e-5)
    assert diag["subcycles"] > 1
    rel = ((exact["energy"] - step["energy"]).abs()
           / step["energy"].abs()).numpy()
    assert np.max(rel) < 2.0e-2, np.max(rel)
    assert np.median(rel) < 5.0e-3


def test_exact_cooling_scope_validation():
    """exact_cooling = 1 takes only the cooling-only tabulated mode, as in
    the JAX package (tests/test_exact_cooling.py)."""
    units = CodeUnits(**_units_kw())
    with pytest.raises(ValueError, match="primordial_chemistry"):
        api.initialize(api.ChemistryConfig(
            use_grackle=1, with_radiative_cooling=1, primordial_chemistry=1,
            exact_cooling=1), units, device="cpu")
    with pytest.raises(ValueError, match="cooling-only"):
        api.initialize(api.ChemistryConfig(
            use_grackle=1, with_radiative_cooling=1, primordial_chemistry=0,
            metal_cooling=1, UVbackground=1, exact_cooling=1), units,
            device="cpu", cloudy_data=synthetic_cloudy_groups())
