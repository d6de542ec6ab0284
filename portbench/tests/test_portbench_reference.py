"""The plain reference against the port's CPU path at a few hundred
cells, for both configurations: the same answers bit for bit."""

import numpy as np
import pytest

from portbench.harness import correct, run_cell, spec

CASES = [("chem3_dust.blocks4k", 256), ("tabulated_uvb.grid1m", 384)]


@pytest.mark.parametrize("name,cells", CASES)
def test_reference_equals_port_on_cpu(name, cells):
    cell = spec.cell(name)
    traffic = dict(cell.traffic, cells=cells, pool=1)
    groups = run_cell.make_groups(cell)
    state = run_cell.make_pool(cell, traffic, 2**31 + 3)[0]
    a_value = run_cell.a_value_of(traffic, 5)
    program = run_cell.Program(cell, groups, "cpu")
    got, _ = program.call(state, a_value, traffic["dt"])
    want = correct.reference_answers(
        cell.config, groups, [(state, a_value, got)], traffic["dt"], 100,
        "cpu")[0]
    err, where = correct.max_rel_err(got, want)
    assert err == 0.0, where
    assert set(got) == set(want) == set(state)
    assert any(not np.array_equal(got[k], state[k]) for k in state)
