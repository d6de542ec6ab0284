"""A run whose timed path is broken comes out not correct, and so does
the control: the program at the configuration's next lower precision.

Each drives the whole run on the CPU at a tiny width (the look for a
card skipped), with the fault planted under the stateful call."""

import numpy as np
import pytest

from grackle_tpu_torch import api

from .helpers import rehearse

CELLS = ["chem3_dust.blocks4k", "tabulated_uvb.one_cell",
         "chem3_dust.grid1m", "tabulated_uvb.grid1m"]


def _unchanged(ctx, fields, dt, *args, **kw):
    """A step that returns its state as it found it."""
    new_f, diag = _solve(ctx, fields, dt, *args, **kw)
    return {k: api._prep_fields(ctx, {k: fields[k]})[0][k]
            for k in new_f}, diag


def _one_answer_altered(ctx, fields, dt, *args, **kw):
    """A step whose answer for one cell is altered by 1% where it is
    made."""
    new_f, diag = _solve(ctx, fields, dt, *args, **kw)
    energy = new_f["energy"].clone()
    energy[-1] = energy[-1] * 1.01
    return dict(new_f, energy=energy), diag


_solve = api.solve_chemistry


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, _ = rehearse(name)
    assert result["correct"] and result["checks"]["max_rel_err"][
        "value"] == 0.0
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [_unchanged, _one_answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(api, "solve_chemistry", fault)
    result, _ = rehearse(name)
    check = result["checks"]["max_rel_err"]
    assert not result["correct"], check
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("name", ["chem3_dust.blocks4k",
                                  "tabulated_uvb.grid1m"])
def test_control_lower_precision_is_not_correct(name):
    # 1,024 cells reach the states where float32 departs most (at 48
    # cells the chemistry-3 control read 4e-4 against the limit 1e-3; on
    # the card, at the cells' widths, 0.06 to 8.5: PERF.md)
    result, note = rehearse(name, program_parameters={"precision": 32},
                            cells=1024)
    check = result["checks"]["max_rel_err"]
    assert not result["correct"], (check, note)
    assert np.isfinite(check["value"])


def test_a_failing_call_is_counted(monkeypatch):
    def fails(*args, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(api, "solve_chemistry", fails)
    with pytest.raises(RuntimeError):
        rehearse("tabulated_uvb.one_cell")
