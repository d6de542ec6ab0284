"""grackle_tpu_torch's remaining modes against grackle_tpu: old-style
(rank 4 and 5) Cloudy metal tables, the heating-option sweep of
tests/test_heating_options.py, the f32 solve against the f64 one
(tests/test_precision.py), and version / info (tests/test_info.py).

Each JAX configuration is initialized from its data file and carried over
to the port as numpy arrays (convert.context_from_numpy), except the
old-style tables, which the JAX package reads from an HDF5 file and the
port builds in memory (data/synthetic.synthetic_old_style_groups).  The
same seeded numpy state goes through both; cooling times run the JAX
function eagerly, solves through its jitted API.  Solver outputs and
cooling times are held at the reference's rtol 1e-6.
"""

import dataclasses
import functools
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu import api as japi
from grackle_tpu import info as jinfo
from grackle_tpu.data import uvb as juvb
from grackle_tpu.data.synthetic import make_synthetic_old_style_file
from grackle_tpu.ops import common as jcommon
from grackle_tpu.ops import derived as jderived
from grackle_tpu.ops import interp as jinterp
from grackle_tpu_torch import api as papi
from grackle_tpu_torch import info as pinfo
from grackle_tpu_torch import version as pversion
from grackle_tpu_torch.config import PARAMETER_REGISTRY
from grackle_tpu_torch.data import uvb as puvb
from grackle_tpu_torch.data.cloudy import load_cloudy_table
from grackle_tpu_torch.data.synthetic import synthetic_old_style_groups
from grackle_tpu_torch.ops import interp as pinterp
from tests.test_torch_derived import _jax_chem
from tests.test_torch_network import jax_context_as_port

torch.set_num_threads(1)

RTOL = 1e-6


def _close(got, want, name, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=0,
                               err_msg=name)


def jax_cooling_time(jcd, f):
    """The JAX package's cooling time of numpy fields ``f``, eager: the
    sweep's configurations share most primitives, which eager JAX
    compiles once, where a jitted call compiles each configuration."""
    ctx = jcd.context
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    return jderived.calculate_cooling_time(
        ctx.config, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal,
        japi._photo_rates(ctx.config, ctx.tables, ctx.uvb, ctx.units),
        jcommon.make_unit_scalars(ctx.config, ctx.tables, ctx.units), jf,
        "metal" in jf, ctx.cloudy_data_new,
        bool(ctx.units.comoving_coordinates))


def with_energy(cfg, units, f, T):
    """Set the energy of a state to temperature T with the mean molecular
    weight of its species and metal (FluidContainer's formula for a state
    without energy)."""
    nden = f["metal"] / 16.0 + f["HI"] + f["HII"] + f["de"] + (
        f["HeI"] + f["HeII"] + f["HeIII"]) / 4.0
    if cfg.primordial_chemistry > 1:
        nden = nden + f["HM"] + (f["H2I"] + f["H2II"]) / 2.0
    mu = f["density"] / nden
    f["energy"] = T / units.temperature_units / mu / (cfg.Gamma - 1.0)
    return f


# --- old-style Cloudy tables ----------------------------------------------


def test_interpolate_4d_5d_match():
    """interpolate_4d and interpolate_5d (bisection axis 4) against the
    JAX package, at points inside and beyond the grids, f64 and f32."""
    rng = np.random.RandomState(8)
    n = 300
    pars = [np.linspace(-6.0, 4.0, 11), np.linspace(-4.0, 0.5, 7),
            np.linspace(-6.0, 0.0, 5), np.array([0.0, 0.5, 2.0, 4.5, 8.0]),
            np.linspace(1.0, 9.0, 81)]
    xs = [rng.uniform(p[0] - 1.0, p[-1] + 1.0, n) for p in pars]
    data5 = rng.uniform(-30, -20, tuple(len(p) for p in pars))
    for dtype in (np.float64, np.float32):
        for name, args in (
                ("interpolate_4d", xs[:3] + xs[4:] + pars[:3] + pars[4:]
                 + [data5[:, :, :, 2]]),
                ("interpolate_5d", xs + pars + [data5])):
            args = [a.astype(dtype) for a in args]
            want = getattr(jinterp, name)(*[jnp.asarray(a) for a in args])
            got = getattr(pinterp, name)(*[torch.from_numpy(a)
                                           for a in args])
            assert got.dtype == torch.from_numpy(args[0]).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{name} {dtype}")


@pytest.fixture(scope="module")
def old_style_file(tmp_path_factory):
    def write(rank):
        path = tmp_path_factory.mktemp("old") / f"old_style_r{rank}.h5"
        return str(make_synthetic_old_style_file(path, rank=rank))

    return functools.lru_cache(maxsize=None)(write)


@pytest.mark.parametrize("rank", [4, 5])
def test_old_style_tables_match(old_style_file, rank):
    """Both packages detect the old style, load the same rank-4/5 table
    (the port from memory and from the file alike), and agree on the
    cooling time at two metallicities and on a chemistry-1 solve; more
    metal cools faster, as in tests/test_old_style_tables.py."""
    path = old_style_file(rank)
    jcd = _jax_chem(grackle_data_file=path, primordial_chemistry=1,
                    metal_cooling=1)
    pcd = chip_smoke.old_style_chem("cpu", rank)
    ctx = pcd.context
    assert ctx.cloudy_data_new is False and jcd.context.cloudy_data_new \
        is False
    assert ctx.cloudy_metal.grid_rank == rank
    from_file = load_cloudy_table(path, "Metals", ctx.units,
                                  read_heating=True, read_mmw=False)
    from_memory = load_cloudy_table(synthetic_old_style_groups(rank),
                                    "Metals", ctx.units, read_heating=True,
                                    read_mmw=False)
    for field in dataclasses.fields(from_file):
        a, b = getattr(from_file, field.name), getattr(from_memory,
                                                       field.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), field.name
    for name in ["par1", "par2", "par3", "par4", "par5", "cooling"]:
        want = getattr(jcd.context.cloudy_metal, name)
        if want is not None:
            np.testing.assert_array_equal(
                getattr(ctx.cloudy_metal, name).numpy(), np.asarray(want),
                err_msg=name)

    times = {}
    for zfrac in (1e-6, 0.04):
        f = chip_smoke.old_style_state(pcd, zfrac)
        got = pcd.calculate_cooling_time(f)
        _close(got, jax_cooling_time(jcd, f), f"cooling_time Z {zfrac}")
        assert bool(torch.isfinite(got).all())
        times[zfrac] = got
    assert bool((times[0.04].abs() < times[1e-6].abs()).all())

    f = chip_smoke.old_style_state(pcd, 0.04)
    want, jdiag = jcd.solve_chemistry(dict(f), 1.0e-4)
    got, diag = pcd.solve_chemistry(f, 1.0e-4)
    assert bool(diag["converged"].all())
    np.testing.assert_array_equal(diag["cell_iterations"].numpy(),
                                  np.asarray(jdiag["cell_iterations"]))
    for key in ["HI", "HII", "de", "energy"]:
        _close(got[key], want[key], key)


# --- the heating-option sweep ---------------------------------------------


def neutral_state(cfg, units, n=12, T0=5.0e3, density=10.0, x_e=1e-20):
    """tests/test_heating_options.neutral_state, as numpy fields."""
    tiny = 1e-20
    d = np.full(n, density)
    f = {"density": d, "HI": 0.76 * d * max(1.0 - x_e, tiny),
         "HII": 0.76 * d * x_e + tiny, "HeI": 0.24 * d,
         "HeII": np.full(n, tiny), "HeIII": np.full(n, tiny),
         "metal": 0.01 * d}
    f["de"] = f["HII"].copy()
    f["HM"] = np.full(n, tiny)
    f["H2I"] = 1e-4 * d
    f["H2II"] = np.full(n, tiny)
    return with_energy(cfg, units, f, T0)


_MET = {"metal_cooling": 1}
#: the sweep of tests/test_heating_options.py: name -> (parameters, state
#: options, extra fields, "cooling_time" or the dt of a solve)
SWEEP = {
    "pe1": (dict(_MET, photoelectric_heating=1), dict(x_e=1e-3), {},
            "cooling_time"),
    "pe2": (dict(_MET, photoelectric_heating=2), dict(x_e=1e-3), {},
            "cooling_time"),
    "pe3": (dict(_MET, photoelectric_heating=3), dict(x_e=1e-3), {},
            "cooling_time"),
    "isrf": (dict(_MET, photoelectric_heating=2, use_isrf_field=1), {},
             {"isrf_habing": (0.1, 100.0)}, "cooling_time"),
    "dust_density": (dict(_MET, dust_chemistry=1, use_dust_density_field=1),
                     dict(T0=1.0e3, density=1.0e4),
                     {"dust": (1e-6 * 1.0e4, 1e-2 * 1.0e4)}, 1.0e-5),
    "compton_xray": (dict(_MET, UVbackground=1, Compton_xray_heating=1,
                          comoving_coordinates=1, a_units=0.01,
                          a_value=100.0 / (1.0 + 3.0)),
                     dict(T0=1.0e6, density=1e-3, x_e=0.999), {},
                     "cooling_time"),
    "lw_sawtooth": (dict(UVbackground=0, LWbackground_intensity=100.0,
                         LWbackground_sawtooth_suppression=1),
                    dict(T0=1.0e3, density=1.0e2), {}, 1.0e-4),
    "h2_variant0": (dict(h2_cooling_variant=0),
                    dict(T0=2.0e3, density=1.0e4), {}, "cooling_time"),
    "h2_variant1": (dict(h2_cooling_variant=1),
                    dict(T0=2.0e3, density=1.0e4), {}, "cooling_time"),
    "h2_variant2": (dict(h2_cooling_variant=2),
                    dict(T0=2.0e3, density=1.0e4), {}, "cooling_time"),
}


@functools.lru_cache(maxsize=None)
def _sweep_contexts(name):
    params = SWEEP[name][0]
    jcd = _jax_chem(primordial_chemistry=2, **params)
    return jcd, jax_context_as_port(jcd)


@pytest.mark.parametrize("name", list(SWEEP))
def test_heating_option_sweep(name):
    """Each option of the sweep on a port context carried over from the
    JAX package's: the cooling time (or, for the dust-density and LW
    sawtooth options, a solve) of the sweep's state, with each extra
    field at both of the sweep's values, against JAX at rtol 1e-6."""
    _, state_kw, extra, what = SWEEP[name]
    jcd, ctx = _sweep_contexts(name)
    base = neutral_state(ctx.config, ctx.units, **state_kw)
    for values in zip(*extra.values()) if extra else [()]:
        f = dict(base, **{k: np.full(12, v) for k, v in zip(extra, values)})
        if what == "cooling_time":
            got = papi.calculate_cooling_time(ctx, f)
            _close(got, jax_cooling_time(jcd, f), f"{name} {values}")
            assert bool(torch.isfinite(got).all())
            continue
        want, _ = jcd.solve_chemistry(dict(f), what)
        got, diag = papi.solve_chemistry(ctx, f, what)
        assert bool(diag["converged"].all())
        for key in want:
            _close(got[key], want[key], f"{name} {values} {key}")


def test_lw_sawtooth_uvb_ramp():
    """The UVB-path sawtooth (update_UVbackground_rates.c:241-256): k31
    against the JAX package's across the ramp, in the full-on window,
    just inside redshift_on and past it, with and without suppression;
    the ramp's midpoint factor is 0.55 and its floor 0.1."""
    k31 = {}
    for saw in (0, 1):
        jcd = _jax_chem(
            primordial_chemistry=2, UVbackground=1, metal_cooling=1,
            LWbackground_intensity=100.0,
            LWbackground_sawtooth_suppression=saw,
            UVbackground_redshift_on=7.0, UVbackground_redshift_fullon=3.0,
            comoving_coordinates=1, a_units=1.0)
        ctx = jax_context_as_port(jcd)
        for z in (1.0, 5.0, 6.9, 9.0):
            units = dataclasses.replace(jcd.context.units,
                                        a_value=1.0 / (1.0 + z))
            got = puvb.update_uvb_rates(ctx.config, ctx.uvb, units).k31
            want = float(juvb.update_uvb_rates(jcd.context.config,
                                               jcd.context.uvb, units).k31)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
            k31[saw, z] = got
    assert k31[1, 1.0] == pytest.approx(k31[0, 1.0], rel=1e-6)
    assert k31[1, 5.0] == pytest.approx(0.55 * k31[0, 5.0], rel=1e-3)
    assert k31[1, 6.9] == pytest.approx(0.1 * k31[0, 6.9], rel=1e-3)
    assert k31[0, 9.0] == 0.0 and k31[1, 9.0] == 0.0


# --- precision --------------------------------------------------------------


def _precision_state(cd, n=24):
    """tests/test_precision.setup's state."""
    rng = np.random.RandomState(3)
    tiny = 1e-20
    d = 10.0 ** rng.uniform(-1, 2, n)
    f = {"density": d, "HI": 0.5 * 0.76 * d, "HII": 0.5 * 0.76 * d,
         "HeI": 0.24 * d, "HeII": np.full(n, tiny),
         "HeIII": np.full(n, tiny), "metal": np.zeros(n)}
    f["de"] = f["HII"] + f["HeII"] / 4 + f["HeIII"] / 2
    if cd.primordial_chemistry > 1:
        f.update(HM=np.full(n, tiny), H2I=1e-5 * d, H2II=np.full(n, tiny))
    if cd.primordial_chemistry > 2:
        f.update(DI=2.0 * 3.4e-5 * d, DII=np.full(n, tiny),
                 HDI=np.full(n, tiny))
    return with_energy(cd.config, cd.code_units, f,
                       10.0 ** rng.uniform(4.5, 6.5, n))


@pytest.mark.parametrize("chem", [1, 3])
def test_f32_matches_f64(chem):
    """The float32 solve tracks the double one to 5e-3 over one
    physically sized step (tests/test_precision.py), each precision
    taking its own dt from its own cooling time; tensors stay f32."""
    results = {}
    for prec in (64, 32):
        cd = chip_smoke.answer_chem("cpu", precision=prec,
                                    primordial_chemistry=chem)
        assert cd.context.tables.k1.dtype == (
            torch.float64 if prec == 64 else torch.float32)
        f = _precision_state(cd)
        ct = cd.calculate_cooling_time(f)
        assert ct.dtype == cd.context.tables.k1.dtype
        new_f, _ = cd.solve_chemistry(f, 0.1 * float(ct.abs().min()))
        results[prec] = {k: new_f[k].double() for k in
                         ["HI", "HII", "de", "energy"]}
    for name, want in results[64].items():
        np.testing.assert_allclose(results[32][name].numpy(), want.numpy(),
                                   rtol=5e-3, err_msg=name)


# --- version and info -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _info_contexts():
    """A JAX context of one non-default configuration, and the port's
    context of the same resolved parameters."""
    jcd = _jax_chem(primordial_chemistry=2, Gamma=1.4)
    return jcd.context, jax_context_as_port(jcd)


def test_show_parameters_matches_jax():
    """show_parameters prints every registered parameter, in the JAX
    package's lines, for the same resolved configuration."""
    jctx, ctx = _info_contexts()
    got, want = io.StringIO(), io.StringIO()
    pinfo.show_parameters(ctx.config, got)
    jinfo.show_parameters(jctx.config, want)
    assert got.getvalue() == want.getvalue()
    for name in PARAMETER_REGISTRY:
        assert name in got.getvalue()


def test_info_file_matches_jax(tmp_path):
    """write_info_file: the version header, then the JAX package's units
    and parameter sections; non-default values shown."""
    jctx, ctx = _info_contexts()
    got = open(pinfo.write_info_file(ctx.config, ctx.units,
                                     str(tmp_path / "p"))).read()
    want = open(jinfo.write_info_file(jctx.config, jctx.units,
                                      str(tmp_path / "j"))).read()
    assert "grackle_tpu_torch version:" in got
    assert got.split("== units ==")[1] == want.split("== units ==")[1]
    line = [ln for ln in got.splitlines() if ln.startswith("Gamma")][0]
    assert "1.4" in line
    line = [ln for ln in got.splitlines()
            if ln.startswith("primordial_chemistry")][0]
    assert "2" in line


def test_verbose_initialize_writes_info(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    pinfo.set_verbose(True)
    try:
        chip_smoke.answer_chem("cpu", primordial_chemistry=1)
    finally:
        pinfo.set_verbose(False)
    assert os.path.exists(tmp_path / "GRACKLE_TPU_INFO")
    assert "Initializing grackle_tpu_torch data." in capsys.readouterr().out


def test_get_grackle_version(monkeypatch):
    """The version struct, and "N/A" for branch and revision where git
    cannot run (a machine without git, an unpacked git archive)."""
    v = pversion.get_grackle_version()
    assert [int(x) for x in v.version.split(".")]
    assert isinstance(v.branch, str) and isinstance(v.revision, str)

    def no_git(*args, **kw):
        raise FileNotFoundError("git")

    monkeypatch.setattr(pversion.subprocess, "run", no_git)
    v = pversion.get_grackle_version()
    assert (v.branch, v.revision) == ("N/A", "N/A") and v.version
