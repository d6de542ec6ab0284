"""grackle_tpu_torch's converged-cell compaction against its own
monolithic solve (the port's counterpart of tests/test_compaction.py).

The per-cell update has no cross-cell coupling, so running cells on tiles
and on gathered batches changes no cell's subcycle sequence: every cell
takes the subcycles it takes in the monolithic loop, and every field is
bit-identical.  That holds here on the CPU, in f64 and f32, although
PyTorch's CPU ``pow`` can round an element differently in the vectorised
body of its loop than in its scalar tail and compaction moves cells to
other positions; should a case ever differ by that ulp, the identical
``cell_iterations`` are the invariant and an rtol of 1e-12 in f64 the
bound.  On the card every element takes the same path, and chip_smoke.py
phase 4b holds the 1,048,576-cell flagship bit for bit.
"""

import pytest
import torch

from grackle_tpu_torch import api
from grackle_tpu_torch.ops import solver
from grackle_tpu_torch.ops.common import block_scalars
from tests.test_torch_network import port_chem, state

torch.set_num_threads(1)


def _assert_same(comp, mono):
    """Identical per-cell subcycle counts, retirements and fields."""
    assert torch.equal(comp.cell_iterations, mono.cell_iterations)
    assert torch.equal(comp.converged, mono.converged)
    assert sorted(comp.fields) == sorted(mono.fields)
    for key, want in mono.fields.items():
        assert torch.equal(comp.fields[key], want), key


def _result(fields, diag):
    return solver.SolveResult(fields=fields, n_iterations=None,
                              converged=diag["converged"],
                              cell_iterations=diag["cell_iterations"])


#: the warm-phase length and the configurations the compacted carry
#: packs differently: the Neumaier pairs, dust and metal fields, and
#: tabulated mode with its UVB heating
CONFIGS = {
    "warm4": (4, dict(primordial_chemistry=2)),
    "warm16": (16, dict(primordial_chemistry=2)),
    "compensated_dust": (4, dict(primordial_chemistry=3, metal_cooling=1,
                                 dust_chemistry=1, compensated_sums=1)),
    "tabulated_uvb": (4, dict(primordial_chemistry=0, metal_cooling=1,
                              UVbackground=1)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_compaction_bit_identical(monkeypatch, name):
    """The public path: solve_chemistry takes 'compact' above the (here
    lowered) threshold, with solver_compaction warm subcycles and the
    n/4 batch, and equals the monolithic solve bit for bit."""
    monkeypatch.setattr(api, "_COMPACT_MIN_BUCKET", 32)
    warm, kw = CONFIGS[name]
    cd = port_chem(64, solver_compaction=warm, **kw)
    f = state(cd, n=128)
    assert api.solve_path(cd.config, 128) == "compact"
    new_c, diag_c = cd.solve_chemistry(dict(f), 1.0e-4)
    new_m, diag_m = port_chem(64, solver_compaction=0,
                              **kw).solve_chemistry(dict(f), 1.0e-4)
    assert diag_m["trips"] == 0 and diag_c["trips"] > 0
    assert bool(diag_c["converged"].all())
    _assert_same(_result(new_c, diag_c), _result(new_m, diag_m))


def _direct(cd, f, dt, compacted, **kw):
    """The solver entry points called directly, with explicit batch and
    tile arguments."""
    ctx = cd.context
    cfg = ctx.config
    fields, imetal = api._prep_fields(ctx, f)
    us, pr, _ = block_scalars(api.call_scalars(ctx, "cpu"))
    args = (cfg, ctx.tables, ctx.cloudy_primordial, ctx.cloudy_metal, pr,
            us, fields, dt)
    if compacted:
        return solver.solve_rate_cool_compacted(*args, imetal=imetal, **kw)
    return solver.solve_rate_cool(*args, imetal=imetal)


@pytest.mark.parametrize("precision", [64, 32])
def test_compaction_overlapped_final_tile(precision):
    """n = 260 with 48-cell tiles and batches: six warm tiles, the last
    clamped to [212, 260) so 28 cells run twice (masked no-ops once done,
    an earlier advance while active); several outer trips."""
    cd = port_chem(precision, primordial_chemistry=2)
    f = state(cd, n=260)
    mono = _direct(cd, f, 1.0e-4, False)
    comp = _direct(cd, f, 1.0e-4, True, warm=8, batch=48, tile=48)
    assert comp.trips > 1
    _assert_same(comp, mono)


def test_compaction_tile_narrower_than_batch():
    """Tile and batch widths are independent: 24-cell warm tiles under
    64-cell batches."""
    cd = port_chem(64, primordial_chemistry=1)
    f = state(cd, n=200)
    mono = _direct(cd, f, 1.0e-4, False)
    comp = _direct(cd, f, 1.0e-4, True, warm=4, batch=64, tile=24)
    assert comp.trips > 0
    _assert_same(comp, mono)


def test_compaction_respects_max_iterations(monkeypatch):
    """The cap retires cells in the warm phase and in the trips alike:
    no cell runs more than max_iterations subcycles, the capped cells are
    reported, and the counts equal the monolithic solve's."""
    monkeypatch.setattr(api, "_COMPACT_MIN_BUCKET", 64)
    kw = dict(primordial_chemistry=2, max_iterations=5)
    cd = port_chem(64, solver_compaction=3, **kw)
    f = state(cd, n=256)
    new_c, diag_c = cd.solve_chemistry(dict(f), 1.0e-2)
    new_m, diag_m = port_chem(64, solver_compaction=0, **kw).solve_chemistry(
        dict(f), 1.0e-2)
    assert int(diag_c["n_iterations"]) <= 5
    assert not bool(diag_c["converged"].all())
    assert diag_c["trips"] > 0
    _assert_same(_result(new_c, diag_c), _result(new_m, diag_m))


def test_compaction_counts_every_subcycle(monkeypatch):
    """subcycles (the network launches) is the sum over the warm tiles and
    the trips; each tile and trip runs at most its step count."""
    monkeypatch.setattr(api, "_COMPACT_MIN_BUCKET", 64)
    seen = []
    real = solver.run_subcycles

    def record(*args, **kw):
        carry, steps = real(*args, **kw)
        seen.append((kw["chunk"], steps))
        return carry, steps

    monkeypatch.setattr(solver, "run_subcycles", record)
    cd = port_chem(64, primordial_chemistry=1, solver_compaction=6)
    _, diag = cd.solve_chemistry(state(cd, n=256), 1.0e-4)
    assert diag["subcycles"] == sum(steps for _, steps in seen)
    assert len(seen) == 1 + diag["trips"]
    assert seen[0] == (6, 6)
    assert all(steps <= chunk for chunk, steps in seen)


def test_compaction_off_below_threshold():
    """Below 4 * _COMPACT_MIN_BUCKET cells the monolithic path runs."""
    cd = port_chem(64, primordial_chemistry=2)
    assert cd.solver_compaction > 0
    new_f, diag = cd.solve_chemistry(state(cd, n=128), 1.0e-5)
    assert diag["trips"] == 0
    assert bool(diag["converged"].all())
    assert bool(torch.isfinite(new_f["energy"]).all())


def test_tuned_defaults_locked():
    """The JAX package's defaults, carried over as they are: 24 warm
    subcycles, an absolute 81,920-cell batch clamped to n/4, and warm
    tiles of max(batch, 262,144)."""
    cd = port_chem(64, primordial_chemistry=2)
    assert cd.solver_compaction == 24
    assert api._compact_batch(1 << 20) == 81920
    assert api._compact_batch(1 << 16) == (1 << 16) // 4
    assert api._compact_batch(4 * 8192) == 8192
    assert solver.warm_tile_width(81920) == 262144
    assert solver.warm_tile_width(500_000) == 500_000
