"""grackle_tpu_torch's grid entry point: the config-5 stored answer and
the active-region / ghost-zone handling against grackle_tpu.

The 32^3 grid_full workload (21,840 active cells: 12 species, dust,
metal cooling, the UVB, H2 self-shielding from the full-grid density
stencil, both heating fields, then every derived field) is held here on
every GRID_STRIDE-th active cell, at the reference's rtol 1e-6; cells
do not interact but through the shielding length, which is taken from
the full grid.  chip_smoke.py phase 3 holds every cell on the card.
"""

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from grackle_tpu import api as japi
from grackle_tpu_torch import api as papi
from grackle_tpu_torch.ops.common import make_unit_scalars
from tests.answer_workloads import ANSWER_DIR

torch.set_num_threads(1)

#: the active cells test_grid_full_answer solves: every GRID_STRIDE-th
GRID_STRIDE = 8


def test_grid_full_answer():
    """The grid workload's solve and its five derived fields on every
    GRID_STRIDE-th active cell, with the shielding length of the full
    grid (the grid entry point's, test_grid_ghost_zones_and_stencil),
    against every key of tests/answers/grid_full.npz there."""
    cd, f, sl = chip_smoke.grid_full_setup("cpu")
    ctx = cd.context
    us = make_unit_scalars(ctx.config, ctx.tables, ctx.units,
                           chip_smoke.GRID_DX)
    l_h2 = papi.sobolev_shield_length(torch.from_numpy(f["density"]),
                                      us.xbase1, us.dx_cgs)[sl].reshape(-1)
    sample = slice(None, None, GRID_STRIDE)
    flat = {k: v[sl].reshape(-1)[sample] for k, v in f.items()}
    new_f, diag = cd.solve_chemistry(flat, chip_smoke.GRID_DT,
                                     chip_smoke.GRID_DX,
                                     l_h2shield=l_h2[sample])
    assert bool(diag["converged"].all())
    out = {k: new_f[k] for k in ["HI", "H2I", "HDI", "de", "energy"]}
    for name in chip_smoke.GRID_DERIVED:
        out[name] = getattr(cd, f"calculate_{name}")(new_f)
    stored = np.load(f"{ANSWER_DIR}/grid_full.npz")
    assert sorted(out) == sorted(stored.files)
    n = np.prod([e - s + 1 for s, e in zip(chip_smoke.GRID_START,
                                           chip_smoke.GRID_END)])
    assert stored["energy"].shape == (n,)
    for key in stored.files:
        got = out[key].numpy()
        want = stored[key][sample]
        assert got.dtype == np.float64 and got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=key)


def test_grid_ghost_zones_and_stencil():
    """On an 8^3 grid with asymmetric ghost zones: the ghost zones come
    back untouched, and the active region equals the flat solve of the
    active cells with the shielding length that the JAX package's
    sobolev_shield_length takes from the full grid, ghost zones
    included."""
    start, end = (2, 1, 1), (6, 6, 5)
    cd, f, sl = chip_smoke.grid_full_setup("cpu", shape=(8, 8, 8),
                                           start=start, end=end, seed=3)
    new_f, diag = cd.solve_chemistry_grid(f, chip_smoke.GRID_DT,
                                          grid_start=start, grid_end=end,
                                          grid_dx=chip_smoke.GRID_DX)
    assert bool(diag["converged"].all())
    ghost = np.ones(f["density"].shape, dtype=bool)
    ghost[sl] = False
    for key, val in f.items():
        assert new_f[key].dtype == val.dtype, key
        np.testing.assert_array_equal(new_f[key][ghost], val[ghost],
                                      err_msg=key)

    ctx = cd.context
    us = make_unit_scalars(ctx.config, ctx.tables, ctx.units,
                           chip_smoke.GRID_DX)
    l_h2 = np.asarray(japi.sobolev_shield_length(
        jnp.asarray(f["density"]), us.xbase1, us.dx_cgs))[sl].reshape(-1)
    ours = papi.sobolev_shield_length(torch.from_numpy(f["density"]),
                                      us.xbase1, us.dx_cgs)
    np.testing.assert_array_equal(ours[sl].reshape(-1).numpy(), l_h2)
    flat = {k: v[sl].reshape(-1) for k, v in f.items()}
    want, _ = cd.solve_chemistry(flat, chip_smoke.GRID_DT,
                                 chip_smoke.GRID_DX, l_h2shield=l_h2)
    for key, val in want.items():
        np.testing.assert_array_equal(new_f[key][sl].reshape(-1),
                                      val.numpy(), err_msg=key)
