"""The traffic's states are fixed by the seed, differ across seeds and
cover the same strata on every seed."""

import numpy as np
import pytest

from portbench.harness import run_cell, spec
from portbench.reference.units import CodeUnits

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SMALL = {"cells": 512, "pool": 2}


def pool(name, seed):
    cell = spec.cell(name)
    traffic = dict(cell.traffic,
                   **(SMALL if cell.traffic["cells"] > 1 else {"pool": 64}))
    return cell, traffic, run_cell.make_pool(cell, traffic, seed)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_states(name):
    _, _, a = pool(name, 2**31 + 5)
    _, _, b = pool(name, 2**31 + 5)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            assert np.array_equal(x[key], y[key])


@pytest.mark.parametrize("name", CELLS)
def test_other_seed_other_states(name):
    _, _, a = pool(name, 11)
    _, _, b = pool(name, 12)
    assert not np.array_equal(a[0]["energy"], b[0]["energy"])


@pytest.mark.parametrize("name", CELLS)
def test_strata_cover_the_ranges(name):
    cell, traffic, states = pool(name, 99)
    if traffic["cells"] > 1:
        energy = states[0]["energy"]
    else:
        energy = np.concatenate([s["energy"] for s in states])
    units = CodeUnits(**cell.config["units"])
    gamma = cell.config["parameters"].get("Gamma", 5.0 / 3.0)
    log_t = np.log10(energy * units.temperature_units * traffic["mu"]
                     * (gamma - 1.0))
    lo, hi = traffic["log_temperature"]
    strata = len(energy)
    which = np.floor((log_t - lo) / (hi - lo) * strata).astype(int)
    # one temperature from each stratum (rounding may move an edge one)
    assert np.sum(np.sort(which) != np.arange(strata)) <= 2
    for state in states:
        assert all(np.all(np.isfinite(v)) and np.all(v > 0)
                   for v in state.values())
        if cell.config["parameters"]["primordial_chemistry"] > 0:
            assert np.allclose(state["de"], state["HII"]
                               + state["HeII"] / 4 + state["HeIII"] / 2)
