"""The benchmark's ``chem2_uvb_shield`` deployment on the CPU: chemistry
2 with metal cooling, the UV background at z = 3, Rahmati et al. 2013
HI/HeI self-shielding (``self_shielding_method`` 3) and H2
self-shielding on the Jeans length (``H2_self_shielding`` 3), at f64.

On 512 cells of the cell ``chem2_uvb_shield.grid1m_z3``'s own recipe
and design, at two ``a_value``, the port's stateful solve is held to the
benchmark's plain reference (portbench/reference) bit for bit, and both
to the JAX package's gather path at the solver's rtol 1e-6.  The same
state solved without shielding lands far from the shielded answer, so
the shielding is exercised.
"""

import numpy as np
import pytest
import torch

from grackle_tpu.api import ChemistryData as JChemistryData
from grackle_tpu.data.synthetic import make_synthetic_data_file
from grackle_tpu.ops import lookup as jlookup
from portbench.harness import run_cell, spec
from portbench.reference import solve as ref

torch.set_num_threads(1)

CELL = "chem2_uvb_shield.grid1m_z3"
A_VALUES = [0.25, 0.2501]
#: the round's solver tolerance (ROADMAP, North star): two packages
#: that build their rate tables with their own arithmetic
RTOL_JAX = 1e-6
UNSHIELDED = {"self_shielding_method": 0, "H2_self_shielding": 0}


@pytest.fixture(scope="module")
def setup():
    cell = spec.cell(CELL)
    traffic = dict(cell.traffic, cells=512, pool=1)
    (state,) = run_cell.make_pool(cell, traffic, 2**31 + 11)
    return cell, run_cell.make_groups(cell), state, float(traffic["dt"])


@pytest.fixture(scope="module")
def port(setup):
    """The port's answers at each of A_VALUES."""
    return _port(*setup)


def _port(cell, groups, state, dt, parameters=None, a_values=A_VALUES):
    program = run_cell.Program(cell, groups, "cpu", parameters)
    return [program.call(state, a, dt)[0] for a in a_values]


def _reference(cell, groups, state, dt):
    ctx = ref.context(cell.config["parameters"], cell.config["units"],
                      groups, "cpu")
    return [ref.solve(ref.at_a_value(ctx, a), state, dt) for a in A_VALUES]


def _jax(cell, state, dt, path):
    make_synthetic_data_file(path, **cell.config["tables"])
    jcd = JChemistryData()
    for key, val in cell.config["parameters"].items():
        setattr(jcd, key, val)
    for key, val in cell.config["units"].items():
        setattr(jcd, key, val)
    jcd.use_fused_lookup = 0
    jcd.grackle_data_file = str(path)
    # the f32 splits of the fused TPU lookup are unused on the gather path
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlookup, "pair_split", lambda mat: None)
        assert jcd.initialize() == 1
    out = []
    for a in A_VALUES:
        jcd.a_value = a
        new_f, _ = jcd.solve_chemistry(dict(state), dt)
        out.append({k: np.asarray(v) for k, v in new_f.items()})
    return out


def test_port_reference_and_jax_agree(setup, port, tmp_path):
    cell, groups, state, dt = setup
    want = _reference(cell, groups, state, dt)
    jax = _jax(cell, state, dt, tmp_path / "hm2012_sizes.h5")
    for got, ref_f, jax_f in zip(port, want, jax):
        assert sorted(got) == sorted(ref_f)
        for key in ref_f:
            # the reference is the port's plain path: the same operations
            # in the same order on the CPU
            np.testing.assert_array_equal(got[key], ref_f[key],
                                          err_msg=key)
            np.testing.assert_allclose(jax_f[key], ref_f[key],
                                       rtol=RTOL_JAX, atol=0, err_msg=key)
    # a new a_value changes the photo rates, and with them the answer
    assert not np.array_equal(port[0]["HI"], port[1]["HI"])


def test_shielding_is_exercised(setup, port):
    shielded = port[0]
    (plain,) = _port(*setup, UNSHIELDED, A_VALUES[:1])
    for key in ("HI", "H2I", "energy"):
        rel = np.max(np.abs(plain[key] - shielded[key])
                     / np.abs(shielded[key]))
        assert rel > 1e3 * RTOL_JAX, (key, rel)
