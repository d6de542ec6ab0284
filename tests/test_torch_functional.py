"""grackle_tpu_torch's functional closures: each ``make_*_fn`` against the
stateful API of the same context, bit for bit; ``torch.autograd``
gradients of the derived-field closures against central differences
(the counterpart of tests/test_autodiff.py, at its tolerances); and the
functional_jit example (examples/functional_jit.py) ported inline, as a
Python loop over ``make_solve_fn``, against the JAX package's closures.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
import grackle_tpu
import grackle_tpu.functional as jfn
import grackle_tpu_torch.functional as gfn
from grackle_tpu_torch.api import ChemistryData
from grackle_tpu_torch.fluid_container import FluidContainer
from tests.answer_workloads import ANSWER_DIR, _data_file

torch.set_num_threads(1)


def make_chem(primordial_chemistry=1, **kw):
    """tests/test_solver.make_chem on the port, on the CPU."""
    return chip_smoke.answer_chem(
        "cpu", primordial_chemistry=primordial_chemistry,
        **dict(dict(metal_cooling=0, UVbackground=0), **kw))


def make_fc(cd, n=32, T0=1.0e6, density=1.0, fh=0.76):
    """tests/test_solver.make_fc on the port's FluidContainer."""
    fc = FluidContainer(cd, n)
    tiny = 1e-20
    fc["density"][:] = density
    if cd.primordial_chemistry > 0:
        fc["HII"][:] = fh * fc["density"]
        fc["HI"][:] = tiny * fc["density"]
        fc["HeI"][:] = (1.0 - fh) * fc["density"]
        fc["HeII"][:] = tiny
        fc["HeIII"][:] = tiny
        fc["de"][:] = fc["HII"] + fc["HeII"] / 4 + fc["HeIII"] / 2
    if cd.primordial_chemistry > 1:
        fc["HM"][:] = tiny * fc["density"]
        fc["H2I"][:] = tiny * fc["density"]
        fc["H2II"][:] = tiny * fc["density"]
    if cd.primordial_chemistry > 2:
        fc["DI"][:] = 2.0 * 3.4e-5 * fc["density"]
        fc["DII"][:] = tiny * fc["density"]
        fc["HDI"][:] = tiny * fc["density"]
    fc["metal"][:] = 0.0
    fc.calculate_mean_molecular_weight()
    fc["energy"][:] = T0 / cd.temperature_units / fc["mu"] / (
        cd.Gamma - 1.0)
    return fc


def _fields_of(fc):
    return {k: np.array(v) for k, v in fc.items()
            if k in fc.density_fields or k == "energy"}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if isinstance(val, torch.Tensor):
            assert torch.equal(got[key], val), key
        else:
            assert got[key] == val, key


@pytest.mark.parametrize("chem", [1, 3])
def test_solve_fn_matches_stateful(chem):
    """make_solve_fn gives the stateful solve's fields and diagnostics
    bit for bit (tests/test_functional.py's 64-cell state), and a second
    step from its output equals the stateful call's."""
    cd = make_chem(chem)
    fields = _fields_of(make_fc(cd, n=64, T0=3.0e4))
    solve = gfn.make_solve_fn(cd)
    ref, ref_diag = cd.solve_chemistry(dict(fields), 0.01)
    out, diag = solve(dict(fields), 0.01)
    _assert_same(out, ref)
    _assert_same(diag, ref_diag)
    ref, _ = cd.solve_chemistry(ref, 0.01)
    out, _ = solve(out, 0.01)
    _assert_same(out, ref)


def test_solve_fn_exact_cooling_matches_stateful():
    """The exact-integration branch of the closure, bit for bit (the
    port runs the same eager code on both sides)."""
    cd = chip_smoke.answer_chem("cpu", primordial_chemistry=0,
                                metal_cooling=1, exact_cooling=1)
    fields = chip_smoke.tabulated_state(cd, 128)
    ref, ref_diag = cd.solve_chemistry(dict(fields), 0.5)
    out, diag = gfn.make_solve_fn(cd)(dict(fields), 0.5)
    _assert_same(out, ref)
    _assert_same(diag, ref_diag)
    assert diag["subcycles"] == 0 and int(diag["n_iterations"]) == 1


def test_derived_fns_match_stateful():
    cd = make_chem(2)
    fields = _fields_of(make_fc(cd, n=48, T0=8.0e3))
    for name in ["temperature", "pressure", "gamma", "cooling_time",
                 "dust_temperature"]:
        got = getattr(gfn, f"make_{name}_fn")(cd)(fields)
        want = getattr(cd, f"calculate_{name}")(fields)
        assert torch.equal(got, want), name


def test_requires_initialized():
    with pytest.raises(ValueError):
        gfn.make_solve_fn(ChemistryData())


# --- autograd ----------------------------------------------------------------


def _grad_fields(cd, n=8, T0=1.0e5):
    """tests/test_autodiff._fields: a mixed ionization state, so every
    differentiated species is a finite fraction of the density."""
    fc = make_fc(cd, n=n, T0=T0)
    d = np.array(fc["density"])
    fc["HI"][:] = 0.3 * d
    fc["HII"][:] = 0.4 * d
    fc["de"][:] = np.array(fc["HII"]) + np.array(fc["HeII"]) / 4
    if cd.primordial_chemistry > 1:
        fc["H2I"][:] = 2.0e-3 * d
    return {k: torch.from_numpy(np.array(v))
            for k, v in fc.items()
            if k in fc.density_fields or k == "energy"}


def _fd_check(fn, fields, key, rtol):
    """torch.autograd's gradient of sum(fn) with respect to fields[key],
    summed over cells, against a central finite difference."""
    def loss(x):
        return fn(dict(fields, **{key: x})).sum()

    x0 = fields[key].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x0), x0)
    assert bool(torch.isfinite(g).all()), key
    eps = 1e-6 * float(fields[key].abs().max())
    with torch.no_grad():
        num = (float(loss(fields[key] + eps))
               - float(loss(fields[key] - eps))) / (2 * eps)
    np.testing.assert_allclose(float(g.sum()), num, rtol=rtol, err_msg=key)


@pytest.mark.parametrize("key", ["energy", "HI", "de"])
def test_cooling_time_grad(key):
    cd = make_chem(2)
    _fd_check(gfn.make_cooling_time_fn(cd), _grad_fields(cd), key,
              rtol=1e-4)


@pytest.mark.parametrize("key", ["energy", "HI"])
def test_temperature_grad(key):
    cd = make_chem(2)
    _fd_check(gfn.make_temperature_fn(cd), _grad_fields(cd), key,
              rtol=1e-5)


def test_pressure_and_gamma_grads():
    cd = make_chem(2)
    fields = _grad_fields(cd)
    _fd_check(gfn.make_pressure_fn(cd), fields, "energy", rtol=1e-6)
    _fd_check(gfn.make_gamma_fn(cd), fields, "H2I", rtol=1e-4)


def test_grad_with_metal_cooling():
    """Gradients flow through the Cloudy table interpolation too."""
    cd = make_chem(2, metal_cooling=1)
    fields = _grad_fields(cd)
    fields["metal"] = 0.01 * fields["density"]
    _fd_check(gfn.make_cooling_time_fn(cd), fields, "metal", rtol=1e-3)


# --- the functional_jit example -------------------------------------------


def test_functional_jit_example():
    """examples/functional_jit.py, its scan as a Python loop over the
    closures (chip_smoke.functional_jit_answer, which phase 3 runs on the
    card), against the JAX package's closures on the same state, at rtol
    1e-6: one DT_MYR=1.0 step capped at FUNCTIONAL_JIT_SUBCYCLES
    subcycles.  The stored answer
    (tests/answers/examples/functional_jit.npz) runs every cell into the
    10,000-subcycle cap near the CMB temperature, where an ulp of input
    moves the JAX package's own answer by tens of percent
    (scripts/functional_jit_sensitivity.py), so it is not compared."""
    got = chip_smoke.functional_jit_answer("cpu")
    jcd = chip_smoke.functional_jit_chem(grackle_tpu,
                                         chip_smoke.FUNCTIONAL_JIT_SUBCYCLES)
    jcd.grackle_data_file = _data_file()
    jcd.initialize()
    fc = grackle_tpu.setup_fluid_container(
        jcd, density=0.1, temperature=np.logspace(4.5, 6.5, 64),
        converge=False)
    f = {k: np.array(v) for k, v in fc.items()
         if k in fc.density_fields or k == "energy"}
    new_f, diag = jfn.make_solve_fn(jcd)(f, chip_smoke.FUNCTIONAL_JIT_DT)
    assert int(diag["n_iterations"]) == chip_smoke.FUNCTIONAL_JIT_SUBCYCLES
    want = {"temperature": np.asarray(jfn.make_temperature_fn(jcd)(new_f)),
            "energy": np.asarray(new_f["energy"])}
    want = {"temperature": want["temperature"][None],
            "energy": want["energy"][None], "final_energy": want["energy"]}
    stored = np.load(os.path.join(ANSWER_DIR, "examples",
                                  "functional_jit.npz"))
    assert sorted(got) == sorted(want) == sorted(stored.files)
    for key, val in want.items():
        assert got[key].shape == val.shape, key
        np.testing.assert_allclose(got[key], val, rtol=1e-6, atol=0,
                                   err_msg=key)
