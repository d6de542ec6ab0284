"""grackle_tpu_torch host layers against grackle_tpu: parameters, rate
tables, Cloudy tables, table lookups and interpolation.

The same inputs, made with numpy from a seed, go through the JAX function
and its port; both run on the CPU.  The port must also import with jax
blocked.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grackle_tpu import config as jconfig
from grackle_tpu.data import cloudy as jcloudy
from grackle_tpu.ops import interp as jinterp
from grackle_tpu.ops import lookup as jlookup
from grackle_tpu.rates import tables as jtables
from grackle_tpu.units import CodeUnits as JCodeUnits
from grackle_tpu_torch import config as pconfig
from grackle_tpu_torch.data import cloudy as pcloudy
from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
from grackle_tpu_torch.ops import interp as pinterp
from grackle_tpu_torch.ops import lookup as plookup
from grackle_tpu_torch.rates import tables as ptables
from grackle_tpu_torch.units import CodeUnits as PCodeUnits
from grackle_tpu_torch.utilities.physical_constants import mass_hydrogen_cgs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_FILE = os.path.join(REPO, "tests", "answers", "synthetic_cloudy.h5")
UNITS = dict(comoving_coordinates=0, density_units=mass_hydrogen_cgs,
             length_units=3.0857e21, time_units=3.1556952e13,
             a_units=1.0, a_value=1.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_parameter_registry_matches():
    """Every parameter name, type and default, in the same order."""
    assert list(pconfig.PARAMETER_REGISTRY) == \
        list(jconfig.PARAMETER_REGISTRY)
    for name, (ptype, default) in jconfig.PARAMETER_REGISTRY.items():
        assert pconfig.PARAMETER_REGISTRY[name] == (ptype, default), name


@pytest.mark.parametrize("opts", [
    dict(primordial_chemistry=1, dust_chemistry=1, metal_cooling=1),
    dict(primordial_chemistry=3, dust_chemistry=1, metal_cooling=0),
    dict(primordial_chemistry=0, exact_cooling=1, UVbackground=0),
    dict(primordial_chemistry=3),
], ids=["dust_chem1", "dust_needs_metal", "exact", "plain"])
def test_resolve_config_matches(opts):
    """The derivation and validation rules agree, errors included."""
    def run(mod):
        try:
            cfg = mod.resolve_config(mod.ChemistryConfig(**opts))
        except ValueError as exc:
            return ("error", str(exc))
        return {name: getattr(cfg, name) for name in mod.PARAMETER_REGISTRY}

    assert run(pconfig) == run(jconfig)


# the option sets of tests/answer_workloads.workload_rate_tables
RATE_OPTION_SETS = {
    "default": dict(primordial_chemistry=3),
    "threebody4_caseB": dict(primordial_chemistry=3, three_body_rate=4,
                             CaseBRecombination=1),
    "dust_pe": dict(primordial_chemistry=3, metal_cooling=1,
                    dust_chemistry=1, photoelectric_heating=2),
    "charge_exchange2": dict(primordial_chemistry=2,
                             h2_charge_exchange_rate=2, h2_dust_rate=2,
                             h2_h_cooling_rate=2),
}


@pytest.mark.parametrize("label", list(RATE_OPTION_SETS))
def test_rate_tables_match(label, monkeypatch):
    """Every 1-D table, h2dust and k13dd at the reference's rtol 1e-7
    (the SVD factors and splits of the fused TPU lookup are not ported;
    the JAX build skips its splits here, which are slow to compile and
    compared with nothing)."""
    monkeypatch.setattr(jlookup, "pair_split", lambda mat: None)
    opts = RATE_OPTION_SETS[label]
    jcfg = jconfig.resolve_config(jconfig.ChemistryConfig(**opts))
    pcfg = pconfig.resolve_config(pconfig.ChemistryConfig(**opts))
    want = jtables.build_rate_tables(jcfg, JCodeUnits(**UNITS))
    got = ptables.build_rate_tables(pcfg, PCodeUnits(**UNITS))
    for name in ptables.ARRAY_FIELDS:
        w, g = np.asarray(getattr(want, name)), _np(getattr(got, name))
        assert g.dtype == np.float64 and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=0, err_msg=name)
    for name in ptables.SCALAR_FIELDS:
        w, g = float(getattr(want, name)), getattr(got, name)
        assert isinstance(g, float), name
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=0, err_msg=name)


def test_rate_tables_dtype_and_device():
    cfg = pconfig.default_config(primordial_chemistry=3)
    t = ptables.build_rate_tables(cfg, PCodeUnits(**UNITS),
                                  dtype=torch.float32)
    assert t.k1.dtype == torch.float32 and t.k1.device.type == "cpu"
    assert tuple(t.h2dust.shape) == (cfg.NumberOfTemperatureBins,
                                      cfg.NumberOfDustTemperatureBins)
    assert tuple(t.k13dd.shape) == (cfg.NumberOfTemperatureBins, 14)


_CLOUDY_FIELDS = ["par1", "par2", "par3", "par4", "par5", "cooling",
                  "heating", "mmw"]


def _cloudy_arrays(table):
    return {name: (None if getattr(table, name) is None
                   else _np(getattr(table, name)))
            for name in _CLOUDY_FIELDS}


@pytest.mark.parametrize("group,read_mmw", [("Primordial", True),
                                            ("Metals", False)])
@pytest.mark.parametrize("read_heating", [False, True])
def test_cloudy_table_matches_file_and_memory(group, read_mmw,
                                              read_heating):
    """The port's file loader equals the JAX loader exactly, and the
    in-memory synthetic tables equal the file."""
    units = JCodeUnits(**UNITS)
    want = jcloudy.load_cloudy_table(DATA_FILE, group, units, read_heating,
                                     read_mmw)
    from_file = pcloudy.load_cloudy_table(DATA_FILE, group,
                                          PCodeUnits(**UNITS),
                                          read_heating, read_mmw)
    in_memory = pcloudy.load_cloudy_table(synthetic_cloudy_groups(), group,
                                          PCodeUnits(**UNITS),
                                          read_heating, read_mmw)
    w = _cloudy_arrays(want)
    for got in (from_file, in_memory):
        assert got.grid_rank == want.grid_rank
        assert got.grid_dimension == want.grid_dimension
        for name, arr in _cloudy_arrays(got).items():
            if w[name] is None:
                assert arr is None, name
            else:
                assert arr.dtype == np.float64, name
                np.testing.assert_array_equal(arr, w[name], err_msg=name)
    assert not pcloudy.is_old_style(DATA_FILE)
    assert not pcloudy.is_old_style(synthetic_cloudy_groups())


def _lookup_inputs(dtype):
    rng = np.random.RandomState(5)
    n_bins, t_start, t_end = 600, 1.0, 1.0e9
    # inside, at and beyond both ends of the table
    logtem = np.concatenate([
        rng.uniform(np.log(t_start), np.log(t_end), 200),
        [np.log(t_start), np.log(t_end), -3.0, 30.0],
    ]).astype(dtype)
    table = (10.0 ** rng.uniform(-20, -5, n_bins)).astype(dtype)
    table2 = (10.0 ** rng.uniform(-20, -5, (n_bins, 40))).astype(dtype)
    dlog = rng.uniform(np.log(1.0), np.log(2.0e3), logtem.shape[0])
    return logtem, n_bins, t_start, t_end, table, table2, dlog.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_table_index_and_lookup_match(dtype):
    logtem, n_bins, t0, t1, table, table2, dlog = _lookup_inputs(dtype)
    ti_j = jlookup.table_index(jnp.asarray(logtem), n_bins, t0, t1)
    ti_p = plookup.table_index(torch.from_numpy(logtem), n_bins, t0, t1)
    np.testing.assert_array_equal(_np(ti_p.idx), np.asarray(ti_j.idx))
    for name in ["tdef", "t1", "t2", "logtem"]:
        got = _np(getattr(ti_p, name))
        want = np.asarray(getattr(ti_j, name))
        # the bin edges are float64 in both packages, whatever the dtype
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    tab_j, tab_p = jnp.asarray(table), torch.from_numpy(table)
    np.testing.assert_array_equal(
        _np(plookup.lookup(tab_p, ti_p)),
        np.asarray(jlookup.lookup(tab_j, ti_j)))
    many_p = plookup.lookup_many([tab_p, 2 * tab_p], ti_p)
    many_j = jlookup.lookup_many([tab_j, 2 * tab_j], ti_j)
    for g, w in zip(many_p, many_j):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    # 2-D h2dust table: bilinear in (T_gas, T_dust)
    dti_j = jlookup.table_index(jnp.asarray(dlog), 40, 1.0, 2.0e3)
    dti_p = plookup.table_index(torch.from_numpy(dlog), 40, 1.0, 2.0e3)
    np.testing.assert_array_equal(
        _np(plookup.h2dust_lookup(torch.from_numpy(table2), ti_p, dti_p)),
        np.asarray(jlookup.h2dust_lookup(jnp.asarray(table2), ti_j, dti_j,
                                         use_fused=False)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interpolation_matches(dtype):
    """interpolate_1d..3d and the redshift axis of interpolate_3dz, at
    points inside the grids and beyond their ends (extrapolation)."""
    rng = np.random.RandomState(7)
    n = 300
    par1 = np.linspace(-10.0, 4.0, 25).astype(dtype)
    par2 = np.linspace(0.0, 10.0, 10).astype(dtype)
    par3 = np.linspace(1.0, 9.0, 121).astype(dtype)
    data3 = rng.uniform(-30, -20, (25, 10, 121)).astype(dtype)
    x1 = rng.uniform(-12.0, 6.0, n).astype(dtype)
    x2 = rng.uniform(-1.0, 11.0, n).astype(dtype)
    x3 = rng.uniform(0.5, 9.5, n).astype(dtype)

    def both(fname, *args):
        j = getattr(jinterp, fname)(*[jnp.asarray(a) for a in args])
        p = getattr(pinterp, fname)(*[torch.from_numpy(a) for a in args])
        return _np(p), np.asarray(j)

    for got, want in [
        both("interpolate_1d", x3, par3, data3[3, 4]),
        both("interpolate_2d", x1, x3, par1, par3, data3[:, 2]),
        both("interpolate_3d", x1, x2, x3, par1, par2, par3, data3),
    ]:
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, want)

    for zr in [0.0, 0.37, 3.3, 8.9, 10.0, 12.0]:
        zi_j, end_j = jinterp.redshift_index(zr, jnp.asarray(par2), 10)
        # the port reads the call's redshift as a 0-d tensor
        zr_p = torch.tensor(zr, dtype=torch.from_numpy(par2).dtype)
        zi_p, end_p = pinterp.redshift_index(zr_p, torch.from_numpy(par2),
                                             10)
        assert int(zi_p) == int(zi_j) and bool(end_p) == bool(end_j), zr
        want = jinterp.interpolate_3dz(
            jnp.asarray(x1), zr, jnp.asarray(x3), jnp.asarray(par1),
            jnp.asarray(par2), jnp.asarray(par3), jnp.asarray(data3),
            zi_j, end_j)
        got = pinterp.interpolate_3dz(
            torch.from_numpy(x1), zr_p, torch.from_numpy(x3),
            torch.from_numpy(par1), torch.from_numpy(par2),
            torch.from_numpy(par3), torch.from_numpy(data3), zi_p, end_p)
        # log(1+z) of a host float: libm vs XLA's log, a few ulps apart
        rtol = 1e-13 if dtype == np.float64 else 1e-5
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                                   atol=0, err_msg=str(zr))


def test_port_imports_without_jax_or_h5py():
    """The port, its examples and chip_smoke.py import with jax,
    grackle_tpu, h5py and yt blocked (a None entry in sys.modules makes
    any import of it fail)."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "grackle_tpu", "h5py", "yt"):
    sys.modules[name] = None
import grackle_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(grackle_tpu_torch.__path__,
                                              "grackle_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print(" ".join(mods))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 20
    new = {"functional", "info", "version", "ops.exact_cool",
           "utilities.api", "utilities.convenience", "utilities.evolve",
           "utilities.testing", "utilities.units", "serialization",
           "api_compat", "parallel.sharding", "parallel.distributed",
           "yt_fields", "cshim_bridge", "cshim_build", "examples.common",
           "examples.cooling_rate", "examples.cooling_cell",
           "examples.freefall", "examples.functional_jit",
           "examples.yt_grackle", "data.h5read"}
    assert {f"grackle_tpu_torch.{m}" for m in new} <= mods
