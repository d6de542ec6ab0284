"""grackle_tpu_torch's pygrackle utilities against grackle_tpu's:
setup_fluid_container (with and without converging to equilibrium),
evolve_constant_density and evolve_freefall for a bounded number of
steps, the cosmology units, the testing helpers and the package's
exports.

Both packages start from the same parameters; the JAX package solves
through its jitted API and the port on CPU tensors, in f64.  Every
container field and every evolution record is held at the reference's
rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import grackle_tpu
import grackle_tpu_torch
from grackle_tpu.ops import lookup as jlookup
from grackle_tpu.utilities import testing as jtesting
from grackle_tpu_torch.utilities import api as papi_shim
from grackle_tpu_torch.utilities import testing as ptesting
from grackle_tpu_torch.utilities.convenience import check_convergence
from tests.test_torch_network import UNIT_ATTRS

torch.set_num_threads(1)

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _no_fused_splits(monkeypatch):
    """The f32 splits of the JAX package's fused TPU lookup are unused on
    its CPU gather path, and slow to build."""
    monkeypatch.setattr(jlookup, "pair_split", lambda mat: None)


def _chem(module, **kw):
    """An uninitialized chemistry_data of ``module`` with the answer
    workloads' units and no data file (no metal or tabulated cooling)."""
    cd = module.chemistry_data()
    cd.use_grackle = 1
    cd.with_radiative_cooling = 1
    for k, v in dict(UNIT_ATTRS, metal_cooling=0, UVbackground=0,
                     **kw).items():
        setattr(cd, k, v)
    return cd


def _setup(module, temperature, chem=2, h2_on_dust=0, **kw):
    """``module``'s setup_fluid_container (the port's on the CPU)."""
    if module is grackle_tpu_torch:
        kw["device"] = "cpu"
    return module.setup_fluid_container(
        _chem(module, primordial_chemistry=chem, h2_on_dust=h2_on_dust),
        temperature=temperature, **kw)


def _assert_containers_match(got, want):
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key].dtype == np.float64, key
        np.testing.assert_allclose(got[key], np.asarray(val), rtol=RTOL,
                                   atol=0, err_msg=key)


@pytest.mark.parametrize("chem", [1, 3])
def test_setup_fluid_container_matches(chem):
    """The constant-density container over a short temperature grid:
    species, metal, energy and mu, without converging."""
    T = np.logspace(4.0, 6.0, 8)
    got = _setup(grackle_tpu_torch, T, chem=chem, converge=False)
    want = _setup(grackle_tpu, T, chem=chem, converge=False)
    assert got.n_vals == 8
    _assert_containers_match(got, want)


def test_setup_fluid_container_converges():
    """converge=True iterates solve + cooling time until no species moves
    by more than the tolerance, as the JAX package does, to the same
    state."""
    T = np.logspace(4.0, 5.0, 4)
    kw = dict(chem=1, converge=True, tolerance=0.05, verbose=False)
    got = _setup(grackle_tpu_torch, T, **kw)
    want = _setup(grackle_tpu, T, **kw)
    assert got is not None and want is not None
    _assert_containers_match(got, want)


def test_check_convergence():
    fc = {"HI": np.array([1.0, 2.0]), "de": np.array([1.0, 1.0])}
    near = {"HI": np.array([1.001, 2.0]), "de": np.array([1.0, 1.0])}
    far = {"HI": np.array([1.0, 2.0]), "de": np.array([1.5, 1.0])}
    assert check_convergence(fc, near, tol=0.01)
    assert not check_convergence(fc, far, tol=0.01)


def _records_match(got, want):
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key].shape == np.asarray(val).shape, key
        np.testing.assert_allclose(got[key], np.asarray(val), rtol=RTOL,
                                   atol=0, err_msg=key)


def test_evolve_constant_density_matches():
    """Constant-density cooling from 10^6 K for four steps of 1% of the
    starting cooling time; every record (species, energy, temperature,
    pressure, mu, dust temperature, time) in CGS."""
    T = np.array([1.0e6])
    out = {}
    for module in (grackle_tpu_torch, grackle_tpu):
        fc = _setup(module, T, h2_on_dust=1, converge=False)
        fc.calculate_cooling_time()
        final_time = 3.5 * 0.01 * abs(float(fc["cooling_time"][0]))
        out[module] = module.evolve_constant_density(
            fc, final_time=final_time, safety_factor=0.01, verbose=False)
    assert len(out[grackle_tpu_torch]["time"]) == 4
    _records_match(out[grackle_tpu_torch], out[grackle_tpu])


def test_evolve_freefall_matches():
    """The Omukai (2005) free-fall collapse with the pressure term, from
    10^-24 g/cm^3 until the density grows by 4%: the same steps and
    records (dust temperature included, h2_on_dust on)."""
    out = {}
    for module in (grackle_tpu_torch, grackle_tpu):
        fc = _setup(module, np.array([1.0e3]), h2_on_dust=1,
                    density=1.0e-24, converge=False)
        out[module] = module.evolve_freefall(
            fc, final_density=1.04e-24, safety_factor=0.01,
            include_pressure=True, verbose=False)
    got = out[grackle_tpu_torch]
    assert 2 < len(got["time"]) < 12
    assert "dust_temperature" in got and "force_factor" in got
    _records_match(got, out[grackle_tpu])


def test_cosmology_units_match():
    """make_cosmology_units builds the JAX package's CodeUnits, and
    set_cosmology_units sets the same attributes on a chemistry_data."""
    kw = dict(hubble_constant=0.7, omega_matter=0.3, omega_lambda=0.7,
              current_redshift=3.0, initial_redshift=99.0,
              comoving_box_size=2.0)
    got = grackle_tpu_torch.make_cosmology_units(**kw)
    want = grackle_tpu.make_cosmology_units(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    chems = [module.set_cosmology_units(module.chemistry_data(), **kw)
             for module in (grackle_tpu_torch, grackle_tpu)]
    for name in ["comoving_coordinates", "a_units", "a_value",
                 "density_units", "length_units", "time_units"]:
        assert getattr(chems[0], name) == getattr(chems[1], name), name
    assert chems[0].velocity_units == chems[1].velocity_units


def test_testing_helpers_match():
    """random_logscale draws what the JAX package's draws from the same
    state; assert_rel_equal masks NaNs present in both arrays and fails
    past its digits."""
    got = ptesting.random_logscale(-3, 2, size=5,
                                   random_state=np.random.RandomState(1))
    want = jtesting.random_logscale(-3, 2, size=5,
                                    random_state=np.random.RandomState(1))
    np.testing.assert_array_equal(got, want)
    a = np.array([1.0, np.nan, 3.0])
    ptesting.assert_rel_equal(a, a * (1 + 1e-9), 7)
    with pytest.raises(AssertionError):
        ptesting.assert_rel_equal(a, a * 1.01, 4)


def test_exports_match():
    """The package's top-level names, the lazy yt hook among them, and
    the deprecated utilities.api shims are the JAX package's (submodules
    aside: a package lists those its process has imported)."""
    want = {name for name in dir(grackle_tpu) if not name.startswith("_")}
    want -= {"parallel", "ops", "rates", "data", "yt_fields",
             "cshim_bridge", "api_compat", "serialization"}
    got = {name for name in dir(grackle_tpu_torch)
           if not name.startswith("_")}
    assert want - got == set()
    assert "add_grackle_fields" in got
    assert grackle_tpu_torch.add_grackle_fields.__module__ == \
        "grackle_tpu_torch"
    for name in ["setup_fluid_container", "evolve_constant_density",
                 "evolve_freefall", "set_cosmology_units"]:
        assert getattr(papi_shim, name) is getattr(grackle_tpu_torch, name)
