"""The dust temperature kernel's control flow, constants and backward,
on the CPU.

csrc/dust_temp.cu runs only on the card, where chip_smoke.py phase 2d
holds it to its twin bit for bit.  Here:

- the kernel's algorithm, one cell at a time with its own early exits,
  written with the twin's operations on one-element tensors, equals the
  twin's masked sweeps (ops/dust_temp.py calc_tdust_1d) bit for bit in
  f64 and f32: on the flagship's dust inputs at its first subcycle (a
  cold start) and at a later one (warm), and on drawn cells below and
  above T_SUBL, colder than the CMB, with warm starts that are taken,
  rejected, bracket the root or do not, and cells on which Newton
  reaches ITMAX;
- the source's solve constants are the twin's;
- CPU tensors run the twin and launch nothing, a solve included; the
  launch refuses an active-cell mask (it solves every cell); the
  struct, slots, flags and routing of every kernel:
  tests/test_torch_kernel_lib.py;
- a launch's backward is the twin's: with the launch stood in for by the
  twin on CPU tensors, the gradients through the autograd function are
  the twin's own, bit for bit.
"""

import collections
import re

import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu_torch.ops import dust_kernel
from grackle_tpu_torch.ops import dust_temp as dt

torch.set_num_threads(1)

#: the flagship's cells and the dust calls recorded (its first subcycle's
#: and a later one's)
N_FLAGSHIP_CELLS = 64
LATER_CALL = 7
N_DRAWN = 96
#: cells on which f64 Newton reaches ITMAX from these warm starts (tgas,
#: nh, gasgr, isrf, tdust_init), found by a search over drawn cells
ITMAX_CELLS = [
    (93.07732188510579, 417044.9248198117, 8.835335893759226e-06,
     60.88965452643192, 7.572473889135548),
    (1020.0137426642962, 138402.13815309198, 8.646188042210463e-06,
     11.147042362837652, 5.017513466062673),
    (588.4890026871836, 215388.6457944532, 3.180362503922936e-07,
     2.5585084026678717, 7.91210149854485),
]


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def flagship_calls():
    """The arguments of the flagship solve's first LATER_CALL + 1 dust
    calls on the CPU (f64)."""
    cd = chip_smoke.flagship_chem(64, "cpu")
    fields = chip_smoke.flagship_fields(cd, N_FLAGSHIP_CELLS)
    calls = []
    route = dust_kernel.dust_temperature

    def record(*args, **kw):
        calls.append((args, kw.get("tdust_init")))
        if len(calls) > LATER_CALL:
            raise _Stop
        return route(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dust_kernel, "dust_temperature", record)
        with pytest.raises(_Stop):
            cd.solve_chemistry(dict(fields), 1.0e-4)
    return calls


def drawn_cells(dtype, seed=3):
    """(tgas, nh, gasgr, isrf, tdust_init): cells from 2 K (below the
    CMB's 2.73 K) to 10^4 K, densities and rates over decades, warm
    starts from 1 K to past T_SUBL; then the ITMAX_CELLS."""
    rng = np.random.default_rng(seed)
    cols = [10.0 ** rng.uniform(lo, hi, N_DRAWN)
            for lo, hi in ((0.3, 4.0), (-2.0, 6.0), (-9.0, -5.0),
                           (-2.0, 3.0), (0.0, 3.5))]
    cols = [np.concatenate([c, [cell[k] for cell in ITMAX_CELLS]])
            for k, c in enumerate(cols)]
    return [torch.tensor(c, dtype=dtype) for c in cols]


def per_cell_dust(tgas, nh, gasgr, coef, isrf, trad, tdust_init=None):
    """The kernel's solve: each cell on its own, Newton then bisection,
    each stopping at the cell's own convergence or cap, with the twin's
    operations on one-element tensors.  Returns (tdust, per cell:
    Newton steps, bisection steps, whether the warm bracket was
    taken)."""
    out, steps = [], []
    trad = torch.clamp(trad, min=1.0)
    trad4 = trad * trad * (trad * trad)
    # the initial guesses of every cell at once: PyTorch's CPU pow rounds
    # an element by its place in the vector loop (an ulp in f32 between a
    # one-element tensor and the batch); CUDA's pow rounds each alike
    guess = torch.clamp(torch.pow(isrf * coef / dt.RADF / dt.KGR1, 0.17),
                        min=trad)
    for j in range(tgas.shape[0]):
        tg, n_h, gg = tgas[j:j + 1], nh[j:j + 1], gasgr[j:j + 1]
        g = isrf[j:j + 1] * coef

        def balance(t):
            return dt.calc_gr_balance(t, tg, dt.calc_kappa_gr(t), trad4,
                                      gg, g, n_h)

        tdust = guess[j:j + 1]
        init = None if tdust_init is None else tdust_init[j:j + 1]
        if init is not None and bool(init > trad) and \
                bool(init < dt.T_SUBL):
            tdust = init
        cold = bool(trad >= tg)
        if cold:
            tdust = trad.expand(1)
        newton = not cold and not bool(tg > dt.T_SUBL)
        bisect = not cold
        pert = torch.full_like(tg, dt.PERT_I)
        n_newton = 0
        while newton and n_newton < dt.ITMAX:
            tdplus = torch.clamp((1.0 + pert) * tdust, min=1.0e-3)
            sol, solplus = balance(tdust), balance(tdplus)
            slope = (solplus - sol) / (pert * tdust)
            tnew = tdust - sol / slope
            pert = torch.clamp(torch.minimum(
                pert, 0.5 * torch.abs(tnew - tdust) / tnew), min=dt.MINPERT)
            tdust = tnew
            negative = bool(tnew < trad)
            converged = bool(torch.abs(sol / solplus) < dt.TOL)
            if converged and not negative:
                bisect = False
            newton = not negative and not converged
            n_newton += 1
        t_low = trad.expand(1) if bisect else tdust
        t_high = tg
        bracket = False
        if init is not None and bisect:
            lo = torch.clamp(0.95 * init, min=trad)
            hi = torch.minimum(tg, 1.05 * init)
            if (bool(init > trad) and bool(hi > lo)
                    and bool(balance(lo) > 0.0) and bool(balance(hi) < 0.0)):
                t_low, t_high, bracket = lo, hi, True
        n_bi = 0
        while bisect and n_bi < dt.BI_ITMAX:
            t_mid = 0.5 * (t_low + t_high)
            if n_bi == 0:
                t_mid = torch.clamp(t_mid, max=dt.T_SUBL)
            if bool(balance(t_mid) > 0.0):
                t_low = t_mid
            else:
                t_high = t_mid
            bisect = not bool(torch.abs(t_high - t_low) / t_low
                              <= dt.BI_TOL)
            n_bi += 1
        out.append(t_low)
        steps.append((n_newton, n_bi, bracket))
    return torch.cat(out), steps


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_per_cell_loop_equals_masked_sweep(flagship_calls, dtype):
    (args0, _), (args1, init1) = flagship_calls[0], flagship_calls[LATER_CALL]
    coef = args0[3]
    trad = args0[6].to(dtype)
    tgas, nh, gasgr, isrf, init = drawn_cells(dtype)
    cases = [
        # the flagship's first subcycle: zeros as the warm start
        [a.to(dtype) for a in (args0[0], args0[1], args0[2], args0[4])]
        + [torch.zeros_like(args0[0], dtype=dtype)],
        [a.to(dtype) for a in (args1[0], args1[1], args1[2], args1[4])]
        + [init1.to(dtype)],
        [tgas, nh, gasgr, isrf, None],
        [tgas, nh, gasgr, isrf, init],
    ]
    seen = []
    for tg, n_h, gg, isrf_c, start in cases:
        want = dt.calc_tdust_1d(tg, n_h, gg, coef, isrf_c, None, trad,
                                tdust_init=start)
        got, steps = per_cell_dust(tg, n_h, gg, coef, isrf_c, trad, start)
        assert chip_smoke.same_bits(got, want)
        seen.append(steps)
    flagship_cold, flagship_warm, _, drawn_warm = seen
    # the first subcycle is all above T_SUBL: no Newton, bisection only
    assert all(n == 0 and b > 0 for n, b, _ in flagship_cold)
    # below and above T_SUBL, and CMB-cold cells were drawn
    assert bool((tgas < dt.T_SUBL).any()) and bool((tgas > dt.T_SUBL).any())
    assert bool((tgas < trad).any())
    # warm brackets taken and refused; Newton reaching ITMAX
    both = flagship_warm + drawn_warm
    assert any(br for _, _, br in both)
    assert any(b > 0 and not br for _, b, br in drawn_warm)
    assert any(n == dt.ITMAX for n, _, _ in drawn_warm)
    assert any(0 < n < dt.ITMAX for n, _, _ in both)


def test_solve_constants_are_the_twins():
    """The source's Newton and bisection constants are the twin's."""
    with open(dust_kernel.SOURCE) as fh:
        src = fh.read()
    for name in ("T_SUBL", "KGR1", "KGR200", "TOL", "BI_TOL", "MINPERT",
                 "ITMAX", "BI_ITMAX", "PERT_I"):
        value = re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)
        assert float(value) == getattr(dt, name), name
    assert "4.0 * 5.670373e-5" in src and dt.RADF == 4.0 * 5.670373e-5


def test_cpu_runs_the_twin(flagship_calls, monkeypatch):
    """The router on CPU tensors returns the twin's result and launches
    nothing; a flagship solve on the CPU launches nothing either."""
    monkeypatch.setattr(dust_kernel.library, "launches",
                        collections.Counter())
    (args, init) = flagship_calls[LATER_CALL]
    got = dust_kernel.dust_temperature(*args, tdust_init=init)
    want = dt.calc_tdust_1d(*args, tdust_init=init)
    assert chip_smoke.same_bits(got, want)
    cd = chip_smoke.flagship_chem(64, "cpu")
    cd.solve_chemistry(dict(chip_smoke.flagship_fields(cd, 8)), 1.0e-6)
    assert dust_kernel.library.issued() == 0


def test_refuses_an_active_cell_mask(flagship_calls):
    """The kernel solves every cell: the launch refuses an active-cell
    mask before it checks the device or builds anything."""
    args, init = flagship_calls[LATER_CALL]
    mask = torch.ones_like(args[0], dtype=torch.bool)
    with pytest.raises(ValueError, match="itmask"):
        dust_kernel.dust_temperature_cuda(*args[:5], mask, *args[6:],
                                          tdust_init=init)


def test_backward_is_the_twins(flagship_calls, monkeypatch):
    """The autograd function around the launch, with the launch stood in
    for by the twin (the kernel equals it bit for bit on the card, phase
    2d): on the drawn cells with warm starts, its values and its
    gradients with respect to every per-cell tensor are the twin's own,
    bit for bit (none where the twin's result does not depend on one);
    with no argument asking for a gradient it adds no graph."""
    (flagship, _), = flagship_calls[:1]
    tgas, nh, gasgr, isrf, init = drawn_cells(torch.float64)
    args = [tgas, nh, gasgr, flagship[3], isrf, None, flagship[6], init]
    wrt = (0, 1, 2, 4, 7)

    def prepare(*a):
        with torch.no_grad():
            return (lambda: None), dt.calc_tdust_1d(*a)

    monkeypatch.setattr(dust_kernel, "prepare_launch", prepare)
    runs = []
    for fn in (dust_kernel.dust_temperature_cuda, dt.calc_tdust_1d):
        xs = list(args)
        for i in wrt:
            xs[i] = args[i].clone().requires_grad_(True)
        out = fn(*xs)
        out.square().sum().backward()
        runs.append((out.detach(), [xs[i].grad for i in wrt]))
    (val, got), (want_val, want) = runs
    assert chip_smoke.same_bits(val, want_val)
    # Newton's cells carry a gradient to every per-cell input
    assert all(w is not None for w in want)
    assert all(g is not None and chip_smoke.same_bits(g, w)
               for g, w in zip(got, want))
    assert not dust_kernel.dust_temperature_cuda(*args).requires_grad
