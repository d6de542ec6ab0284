"""The Cloudy kernels' control flow and backward, on the CPU.

csrc/cloudy_interp.cu runs only on the card, where chip_smoke.py phase 2c
holds it to its twins bit for bit.  Here:

- the kernel's fixed point, one cell a thread with an early exit, as a
  plain per-cell loop over the twin's own operations, equals the twin's
  masked block sweep (ops/tabulated_temp.py) bit for bit in f64, with and
  without the metal correction, on a table where about half of the cells
  reach TI_MAX;
- CPU tensors run the twins and launch nothing, a solve included (the
  struct, slots, flags and routing of every kernel:
  tests/test_torch_kernel_lib.py);
- a launch's backward is the twin's: with the launch stood in for by the
  twin on CPU tensors, the gradients through the autograd functions are
  the twin's own, bit for bit.
"""

import collections
import math

import pytest
import torch

import chip_smoke
from grackle_tpu_torch.api import call_scalars
from grackle_tpu_torch.ops import (cloudy_cool, cloudy_kernel, interp,
                                   tabulated_temp)
from grackle_tpu_torch.ops.common import block_scalars

torch.set_num_threads(1)

N_CELLS = 48


@pytest.fixture(scope="module")
def tabulated():
    """A tabulated context (chemistry 0, metal cooling, UVB) on the CPU,
    its scalars as a body reads them, its tables of rank 1 to 3 and
    cells past both edges of each grid."""
    cd = chip_smoke.answer_chem("cpu", primordial_chemistry=0,
                                metal_cooling=1, UVbackground=1)
    us, _, _ = block_scalars(call_scalars(cd.context, "cpu"))
    tables = chip_smoke.cloudy_tables(cd)
    cells = {rank: chip_smoke.cloudy_cells(prim, N_CELLS, us, cd.Gamma)
             for rank, (prim, _) in tables.items()}
    return cd, us, tables, cells


def twin_mu_interp(table, one, us, cfg):
    """The twin's mu(log10 T) of the cells ``one``: what
    tabulated_temperature hands its fixed point."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tabulated_temp, "_fixed_point",
                   lambda mu_interp, *_: mu_interp)
        return tabulated_temp.tabulated_temperature(
            table, one["d"], one["metal"], one["e"], one["rhoH"], us.dom,
            us.zr, cfg.TemperatureStart, cfg.Gamma, us.utem, False)


def per_cell_fixed_point(table, c, us, cfg, imetal):
    """The kernel's fixed point: each cell on its own, stopping at
    convergence or at TI_MAX, with the twin's operations on one-element
    tensors.  Returns (tgas, mmw, cells that reached TI_MAX)."""
    tgas_out, mmw_out, stuck = [], [], 0
    gamma, temstart = cfg.Gamma, cfg.TemperatureStart
    inv_log10 = 1.0 / math.log(10.0)
    for j in range(c["e"].shape[0]):
        one = {k: v[j:j + 1] for k, v in c.items()}
        mu_interp = twin_mu_interp(table, one, us, cfg)
        munew = torch.ones_like(one["e"])
        tgas = torch.zeros_like(one["e"])
        done = False
        for _ in range(tabulated_temp.TI_MAX):
            muold = munew
            tgas_i = torch.clamp((gamma - 1.0) * one["e"] * munew * us.utem,
                                 min=temstart)
            mu = 0.5 * (mu_interp(torch.log(tgas_i) * inv_log10) + muold)
            tgas_i = tgas_i * mu / muold
            done = bool(torch.abs((mu / muold) - 1.0) <= 1.0e-2)
            munew, tgas = mu, tgas_i
            if done:
                break
        stuck += not done
        if imetal and done:
            d, metal = one["d"], one["metal"]
            mu_corr = d / ((d - metal) / munew
                           + metal / tabulated_temp.MU_METAL)
            tgas = tgas * mu_corr / munew
            munew = mu_corr
        tgas_out.append(tgas)
        mmw_out.append(munew)
    return torch.cat(tgas_out), torch.cat(mmw_out), stuck


@pytest.mark.parametrize("imetal", [False, True])
@pytest.mark.parametrize("rank", [1, 3])
def test_per_cell_loop_equals_masked_sweep(tabulated, rank, imetal):
    cd, us, tables, cells = tabulated
    cfg = cd.context.config
    c = cells[rank]
    for table in (tables[rank][0], chip_smoke.zigzag_mmw(tables[rank][0])):
        want = tabulated_temp.tabulated_temperature(
            table, c["d"], c["metal"], c["e"], c["rhoH"], us.dom, us.zr,
            cfg.TemperatureStart, cfg.Gamma, us.utem, imetal)
        tgas, mmw, stuck = per_cell_fixed_point(table, c, us, cfg, imetal)
        assert chip_smoke.same_bits(tgas, want[0])
        assert chip_smoke.same_bits(mmw, want[1])
    # the zigzag table leaves cells unconverged at TI_MAX
    assert 0 < stuck < N_CELLS


def test_cpu_runs_the_twins(tabulated, monkeypatch):
    """The routers on CPU tensors return the twins' results and launch
    nothing; a tabulated solve on the CPU goes through the twins'
    interpolations and launches nothing either."""
    cd, us, tables, cells = tabulated
    cfg = cd.context.config
    prim, met = tables[3]
    c = cells[3]
    monkeypatch.setattr(cloudy_kernel.library, "launches",
                        collections.Counter())
    args = (prim, c["d"], c["metal"], c["e"], c["rhoH"], us.dom, us.zr,
            cfg.TemperatureStart, cfg.Gamma, us.utem, True)
    got = cloudy_kernel.tabulated_temperature(*args)
    want = tabulated_temp.tabulated_temperature(*args)
    assert all(chip_smoke.same_bits(g, w) for g, w in zip(got, want))
    args = (met, c["logtem"], c["rhoH"], c["metallicity"], us.dom, us.zr,
            us.comp2, 1, 1, 1)
    assert chip_smoke.same_bits(cloudy_kernel.cloudy_cooling(*args),
                                cloudy_cool.cloudy_cooling(*args))

    calls = []
    interpolate_3dz = interp.interpolate_3dz

    def watched(x1, *a, **kw):
        calls.append(x1.device.type)
        return interpolate_3dz(x1, *a, **kw)

    monkeypatch.setattr(interp, "interpolate_3dz", watched)
    state = chip_smoke.tabulated_state(cd, 8)
    cd.solve_chemistry(state, 1.0e-4)
    assert calls and set(calls) == {"cpu"}
    assert cloudy_kernel.library.issued() == 0


@pytest.mark.parametrize("entry", ["fixed_point", "cooling"])
def test_backward_is_the_twins(tabulated, monkeypatch, entry):
    """The autograd function around each launch, with the launch stood in
    for by the twin (the kernel equals it bit for bit on the card, phase
    2c): its values and its gradients with respect to every tensor
    argument are the twin's own, bit for bit, and arguments that need no
    gradient get none."""
    cd, us, tables, cells = tabulated
    cfg = cd.context.config
    prim, met = tables[3]
    c = cells[3]
    if entry == "fixed_point":
        twin, kern = tabulated_temp.tabulated_temperature, \
            cloudy_kernel.fixed_point_cuda
        args = [prim, c["d"], c["metal"], c["e"], c["rhoH"], us.dom, us.zr,
                cfg.TemperatureStart, cfg.Gamma, us.utem, True]
        wrt = (1, 2, 3, 4)
    else:
        twin, kern = cloudy_cool.cloudy_cooling, cloudy_kernel.cooling_cuda
        args = [met, c["logtem"], c["rhoH"], c["metallicity"], us.dom,
                us.zr, us.comp2, 1, 1, 1]
        wrt = (1, 2, 3)

    def prepare(*a):
        with torch.no_grad():
            return (lambda: None), twin(*a)

    monkeypatch.setattr(cloudy_kernel, f"prepare_{entry}", prepare)
    grads = []
    for fn in (kern, twin):
        xs = list(args)
        for i in wrt:
            xs[i] = args[i].clone().requires_grad_(True)
        out = fn(*xs)
        out = out if isinstance(out, tuple) else (out,)
        # a weight per output, so that each output's gradient counts
        sum((k + 1.0) * o.square().sum() for k, o in enumerate(out)) \
            .backward()
        grads.append(([o.detach() for o in out], [xs[i].grad for i in wrt]))
    (vals, got), (want_vals, want) = grads
    assert all(chip_smoke.same_bits(g, w) for g, w in zip(vals, want_vals))
    assert all(g is not None for g in got)
    assert all(chip_smoke.same_bits(g, w) for g, w in zip(got, want))
    # no argument asks for a gradient: the function adds no graph
    out = kern(*args)
    assert all(not o.requires_grad for o in
               (out if isinstance(out, tuple) else (out,)))
