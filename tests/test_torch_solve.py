"""grackle_tpu_torch's ``solve_chemistry`` end to end on the CPU: the
stored answers of the JAX package, one live JAX solve on identical
tables, and the public API of the port.

On CPU tensors every subcycle's network region runs the plain twin
(ops/network.py); the CUDA kernel is held to that twin on the card by
chip_smoke.py.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu.api import ChemistryData as JChemistryData
from grackle_tpu.ops import lookup as jlookup
from grackle_tpu_torch import api, solve_path
from grackle_tpu_torch.fluid_container import FluidContainer
from grackle_tpu_torch.ops import solver
from tests.answer_workloads import ANSWER_DIR, _data_file
from tests.test_torch_network import (UNIT_ATTRS, jax_context_as_port,
                                      port_chem, state)

torch.set_num_threads(1)

#: the flat answer workloads of tests/answer_workloads.py (grid_full is
#: tests/test_torch_grid.py's)
ANSWERS = [name for name in chip_smoke.ANSWERS if name != "grid_full"]


@pytest.mark.parametrize("name", ANSWERS)
def test_stored_answers(name):
    """The port's f64 workload (solve and derived fields, 32 cells, seed
    4) against every key of the JAX package's stored answer, at the
    reference's rtol 1e-6; the in-memory Cloudy and UVB tables equal the
    data file (test_torch_tables)."""
    out = chip_smoke.ANSWERS[name]("cpu")
    stored = np.load(os.path.join(ANSWER_DIR, f"{name}.npz"))
    assert sorted(out) == sorted(stored.files)
    for key in stored.files:
        got = out[key]
        assert got.dtype == torch.float64 and got.shape == (32,)
        np.testing.assert_allclose(got.numpy(), stored[key], rtol=1e-6,
                                   atol=0, err_msg=key)


@pytest.fixture(scope="module")
def live_12species():
    """The JAX package's 12-species dust solve of a 32-cell state, and
    its context carried over to the port."""
    jcd = JChemistryData()
    jcd.use_grackle = 1
    jcd.with_radiative_cooling = 1
    jcd.precision = 64
    jcd.use_fused_lookup = 0
    for k, v in dict(UNIT_ATTRS, primordial_chemistry=3, metal_cooling=1,
                     dust_chemistry=1, grackle_data_file=_data_file(),
                     ).items():
        setattr(jcd, k, v)
    # the f32 splits of the fused TPU lookup are unused on the gather path
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlookup, "pair_split", lambda mat: None)
        assert jcd.initialize() == 1
    fields = state(jcd, n=32)
    new_f, diag = jcd.solve_chemistry(dict(fields), 1.0e-4)
    want = ({k: np.asarray(v) for k, v in new_f.items()},
            {k: np.asarray(v) for k, v in diag.items()})
    return jax_context_as_port(jcd), fields, want


def test_live_jax_12species(live_12species):
    """On identical tables (convert.context_from_numpy) the port takes
    the same subcycles in every cell as the JAX package and agrees to
    f64 rounding, carried through ~160 stiff subcycles."""
    ctx, fields, (want_f, want_d) = live_12species
    got_f, got_d = api.solve_chemistry(ctx, fields, 1.0e-4)
    np.testing.assert_array_equal(got_d["cell_iterations"].numpy(),
                                  want_d["cell_iterations"])
    assert int(got_d["n_iterations"]) == int(want_d["n_iterations"])
    np.testing.assert_array_equal(got_d["converged"].numpy(),
                                  want_d["converged"])
    for key, want in want_f.items():
        np.testing.assert_allclose(got_f[key].numpy(), want, rtol=1e-9,
                                   atol=0, err_msg=key)


def test_extra_subcycles_are_noops(monkeypatch):
    """The loop reads "any cell active" every CHECK_EVERY subcycles; the
    fully masked subcycles it runs past the last active cell change
    nothing, so the result equals a host check after every subcycle."""
    cd = port_chem(64, primordial_chemistry=1)
    fields = state(cd, n=32)
    got_f, got_d = cd.solve_chemistry(fields, 1.0e-3)
    n_it = int(got_d["n_iterations"])
    assert n_it <= got_d["subcycles"] < n_it + solver.CHECK_EVERY
    monkeypatch.setattr(solver, "CHECK_EVERY", 1)
    one_f, one_d = cd.solve_chemistry(fields, 1.0e-3)
    assert one_d["subcycles"] == n_it
    for key in got_f:
        assert torch.equal(got_f[key], one_f[key]), key
    assert torch.equal(got_d["cell_iterations"], one_d["cell_iterations"])


def test_precision_32_stays_f32():
    """precision = 32 solves in float32 from end to end and lands near
    the f64 solve."""
    kw = dict(primordial_chemistry=3, metal_cooling=1, dust_chemistry=1)
    cd32 = port_chem(32, **kw)
    cd64 = port_chem(64, **kw)
    fields = state(cd64, n=16)
    f32, d32 = cd32.solve_chemistry(fields, 1.0e-5)
    f64, _ = cd64.solve_chemistry(fields, 1.0e-5)
    assert bool(d32["converged"].all())
    for key, val in f32.items():
        assert val.dtype == torch.float32, key
        assert bool(torch.isfinite(val).all()), key
    for key in ["HI", "HII", "de", "energy"]:
        rel = (f32[key].double() - f64[key]).abs() / f64[key].abs()
        assert float(rel.median()) < 1e-4, key


def test_solve_path_and_unported_paths(monkeypatch):
    """solve_path names the JAX package's three paths; 'compact' runs
    (with its threshold lowered here), and only 'exact' still raises
    NotImplementedError naming the ROADMAP item, never running another
    path.  UVbackground = 1 initializes."""
    cfg = api.resolve_config(api.ChemistryConfig(primordial_chemistry=3))
    assert cfg.solver_compaction > 0
    assert solve_path(cfg, 1000) == "monolithic"
    assert solve_path(cfg, 4 * 8192) == "compact"
    exact = api.resolve_config(api.ChemistryConfig(
        primordial_chemistry=0, exact_cooling=1, metal_cooling=1))
    assert solve_path(exact, 10) == "exact"

    monkeypatch.setattr(api, "_COMPACT_MIN_BUCKET", 8)
    cd = port_chem(64, primordial_chemistry=1)
    _, diag = cd.solve_chemistry(state(cd, n=32), 1.0e-4)
    assert diag["trips"] > 0 and bool(diag["converged"].all())
    with pytest.raises(NotImplementedError, match="ROADMAP.*exact"):
        port_chem(64, primordial_chemistry=0, exact_cooling=1,
                  metal_cooling=1).solve_chemistry(state(cd, n=8), 1.0e-4)
    uvb = port_chem(64, primordial_chemistry=3, UVbackground=1)
    assert uvb.context.uvb is not None
    assert uvb.UVbackground_redshift_on == 10.0


def test_device_defaults_to_cuda():
    """The entry points put the context on the CUDA card unless the
    caller asks for the CPU; without a card they raise, naming
    device="cpu", and never fall back."""
    import inspect

    from grackle_tpu_torch import convert

    for fn in (api.initialize, api.ChemistryData.initialize,
               convert.context_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without CUDA")
    cd = api.ChemistryData(use_grackle=1, primordial_chemistry=1)
    for k, v in UNIT_ATTRS.items():
        setattr(cd, k, v)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cd.initialize()
    assert cd.context is None
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.initialize(cd.config, cd.code_units)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.context_from_numpy({}, cd.code_units, {}, {}, {})
    assert port_chem(64, primordial_chemistry=1).context.device.type == "cpu"


def test_fused_lookup_flag_has_no_effect():
    """use_fused_lookup is accepted and changes nothing: the port always
    gathers."""
    kw = dict(primordial_chemistry=2, LWbackground_intensity=10.0,
              H2_self_shielding=3)
    fields = state(port_chem(64, **kw), n=32)
    out = [port_chem(64, use_fused_lookup=flag, **kw).solve_chemistry(
        fields, 1.0e-4)[0] for flag in (0, 1, -1)]
    for other in out[1:]:
        for key in out[0]:
            assert torch.equal(out[0][key], other[key]), key


def test_fluid_container_solve():
    """FluidContainer holds numpy fields, solves through the context and
    keeps its dtype; its derived fields are the context's, and the mean
    molecular weight of a state with energy comes from T and gamma."""
    cd = port_chem(64, primordial_chemistry=2)
    fields = state(cd, n=16)
    fc = FluidContainer(cd, 16)
    for key, val in fields.items():
        fc[key][:] = val
    want, _ = cd.solve_chemistry(fields, 1.0e-4)
    fc.solve_chemistry(1.0e-4)
    for key in ["HI", "H2I", "de", "energy"]:
        assert fc[key].dtype == np.float64
        np.testing.assert_array_equal(fc[key], want[key].numpy())
    solved = fc._solver_fields()
    for name in ["cooling_time", "temperature", "pressure", "gamma",
                 "dust_temperature"]:
        getattr(fc, f"calculate_{name}")()
        want = getattr(cd, f"calculate_{name}")(solved)
        assert fc[name].dtype == np.float64
        np.testing.assert_array_equal(fc[name], want.numpy(), err_msg=name)
    fc.calculate_mean_molecular_weight()
    np.testing.assert_array_equal(
        fc["mu"], fc["temperature"] / (fc["energy"] * (fc["gamma"] - 1.0)
                                       * cd.temperature_units))
