"""grackle_tpu_torch's device loops (ops/device_loop.py) on the CPU.

- ``device_while``'s eager path against the blocked loops it replaced
  (the subcycle loop's, the dust solve's and the tabulated fixed
  point's, written out here as they were), case by case;
- the solve reads nothing on the host but the loop's own reads: a
  ``TorchDispatchMode`` raises on every other host read
  (``_local_scalar_dense``, ``is_nonzero``, ``nonzero``) and on tensors
  made from host data (``lift_fresh``), which a CUDA graph cannot
  capture either.  Those reads are exactly the ones that WHILE nodes
  replace inside a capture (chip_smoke.py phases 4m and 4n capture and
  replay the solves on the card).  The cases cover every configuration
  the stateful API captures (graph_cache.py); the paths without a loop
  read nothing at all;
- a 0-d tensor ``dt`` gives the bits of a float ``dt`` on every path,
  each converted on entry to one form (``ops/common.as_dt``);
- ``make_solve_fn`` with a tensor ``dt`` over three steps, and with a
  caller's operation after it, against the JAX package's closure under
  ``jax.jit`` (tests/test_functional.py:46-93) at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
import grackle_tpu.functional as jfn
import grackle_tpu_torch.functional as gfn
from grackle_tpu_torch import api, graph_cache
from grackle_tpu_torch.ops import device_loop, network, solver
from grackle_tpu_torch.ops.common import as_dt, block_scalars
from tests.test_functional import make_chem as jax_chem
from tests.test_functional import make_fc as jax_fc
from tests.test_torch_functional import _fields_of, make_chem, make_fc

torch.set_num_threads(1)

aten = torch.ops.aten


# --- device_while against the blocked loops ----------------------------


def old_subcycle_loop(cond, body, carry, cap, block):
    """The subcycle loop as it was (ops/solver.py run_subcycles)."""
    step = 0
    while step < cap:
        if step % block == 0 and not bool(cond(carry).any()):
            break
        carry = body(carry, step)
        step += 1
    return carry, step


def old_dust_loop(cond, body, carry, cap, block):
    """The dust solve's loop as it was (ops/dust_temp.py _blocked): whole
    blocks, the body a no-op from the cap on."""
    step = 0
    while step < cap and bool(cond(carry).any()):
        for _ in range(block):
            if step < cap:
                carry = body(carry, step)
            step += 1
    return carry, min(step, cap)


def old_fixed_point_loop(cond, body, carry, cap, block):
    """The tabulated fixed point's loop as it was (ops/tabulated_temp.py):
    TI_MAX steps, stopping at a block's start once every cell is done."""
    for step in range(cap):
        if step % block == 0 and not bool(cond(carry).any()):
            return carry, step
        carry = body(carry, step)
    return carry, cap


def _counting_body(limits):
    """Each lane counts up to its limit; the step index enters the sum."""
    def body(carry, step):
        count, total = carry
        live = count < limits
        return (count + live.to(count.dtype),
                torch.where(live, total + (step + 1) * 0.5, total))
    return body


#: (lane limits, cap, block): no trip, an early exit, a cap that is not a
#: multiple of the block, a body that runs to its cap, one step a check
CASES = {
    "zero_trips": ([0, 0, 0], 10, 4),
    "early_exit": ([1, 5, 2], 40, 4),
    "cap_off_block": ([30, 2, 50], 13, 4),
    "runs_to_cap": ([100] * 3, 30, 8),
    "block_one": ([3, 7, 1], 20, 1),
}


@pytest.mark.parametrize("old", [old_subcycle_loop, old_dust_loop,
                                 old_fixed_point_loop])
@pytest.mark.parametrize("case", list(CASES))
def test_device_while_matches_blocked_loops(case, old):
    limits, cap, block = CASES[case]
    limits = torch.tensor(limits)
    carry = (torch.zeros(3, dtype=torch.int64),
             torch.zeros(3, dtype=torch.float64))
    body = _counting_body(limits)

    def cond(c):
        return c[0] < limits

    (count, total), steps = device_loop.device_while(cond, body, carry,
                                                     cap, block)
    (want_count, want_total), want_steps = old(cond, body, carry, cap,
                                               block)
    assert torch.equal(count, want_count) and torch.equal(total, want_total)
    assert steps == want_steps and isinstance(steps, int)
    assert torch.equal(count, torch.clamp(limits, max=cap))


# --- the only host reads are the loop's own --------------------------


class NoHostReads(TorchDispatchMode):
    """Raises on a host read or a tensor made from host data, except
    inside ``device_loop.host_read``; counts the reads made there."""

    FORBIDDEN = {aten._local_scalar_dense.default, aten.is_nonzero.default,
                 aten.nonzero.default, aten.lift_fresh.default,
                 aten.lift_fresh_copy.default}

    def __init__(self):
        super().__init__()
        self.allowed = False
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.FORBIDDEN:
            if not self.allowed:
                raise AssertionError(
                    f"host read outside device_loop.host_read: {func}")
            self.reads += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_host_reads(monkeypatch):
    mode = NoHostReads()
    real = device_loop.host_read

    def read(flag):
        mode.allowed = True
        try:
            return real(flag)
        finally:
            mode.allowed = False

    monkeypatch.setattr(device_loop, "host_read", read)
    return mode


def _tensors(fields):
    return {k: torch.as_tensor(v) for k, v in fields.items()}


def _flagship(precision, n=16):
    cd = chip_smoke.flagship_chem(precision, "cpu")
    return cd, _tensors(chip_smoke.flagship_fields(cd, n))


def _tabulated(n=16):
    cd = chip_smoke.answer_chem("cpu", primordial_chemistry=0,
                                metal_cooling=1)
    return cd, _tensors(chip_smoke.tabulated_state(cd, n))


def _solve_fn(make):
    cd, f = make()
    solve = gfn.make_solve_fn(cd)
    dt = torch.tensor(DT_READS, dtype=torch.float64)
    return lambda: solve(f, dt)


def _compacted_direct():
    """The compacted solve called directly, with small tile and batch:
    warm tiles, then several outer trips."""
    cd, f = _flagship(64, n=24)
    ctx = cd.context
    fields, imetal = api._prep_fields(ctx, f)
    us, pr, _ = block_scalars(api.call_scalars(ctx, "cpu"))
    dt = torch.tensor(DT_READS, dtype=torch.float64)

    def run():
        res = solver.solve_rate_cool_compacted(
            ctx.config, ctx.tables, ctx.cloudy_primordial,
            ctx.cloudy_metal, pr, us, fields, dt, imetal=imetal, warm=1,
            batch=8, tile=10)
        assert res.trips > 1
        return res
    return run


def _cooling_time():
    cd, f = _flagship(64)
    fn = gfn.make_cooling_time_fn(cd)
    return lambda: fn(f)


def _dust_temperature(precision):
    cd, f = _flagship(precision)
    fn = gfn.make_dust_temperature_fn(cd)
    return lambda: fn(f)


def _float_dt():
    """A solve given a float dt, which it fills in on the device."""
    cd, f = _flagship(64)
    solve = gfn.make_solve_fn(cd)
    return lambda: solve(f, DT_READS)


#: a timestep of a few subcycles, each with its dust solve
DT_READS = 1.0e-8

#: what each case runs: the dust Newton and bisection loops (chemistry 3
#: with dust, f64 and f32), the compacted solve's trip and subcycle
#: loops, the tabulated fixed point, the derived-field closures, a float
#: dt
READ_CASES = {
    "dust_f64": lambda: _solve_fn(lambda: _flagship(64)),
    "dust_f32": lambda: _solve_fn(lambda: _flagship(32)),
    "compacted_direct": _compacted_direct,
    "tabulated_chem0": lambda: _solve_fn(_tabulated),
    "cooling_time_fn": _cooling_time,
    "dust_temperature_fn_f64": lambda: _dust_temperature(64),
    "dust_temperature_fn_f32": lambda: _dust_temperature(32),
    "float_dt": _float_dt,
}


def _config_solve(n=16, l_h2shield=None, state=None, **kw):
    """make_solve_fn on the answer workloads' chemistry with ``kw``, its
    state (the tabulated one for chemistry 0) on ``n`` cells."""
    cd = chip_smoke.answer_chem("cpu", **kw)
    if state is None:
        state = (chip_smoke.tabulated_state(cd, n)
                 if cd.primordial_chemistry == 0
                 else chip_smoke.answer_state(cd, n=n))
    solve = gfn.make_solve_fn(cd)
    f = _tensors(state)
    dt = torch.tensor(DT_READS, dtype=torch.float64)
    return lambda: solve(f, dt, l_h2shield=l_h2shield)


def _old_style(rank):
    cd = chip_smoke.old_style_chem("cpu", rank)
    solve = gfn.make_solve_fn(cd)
    f = _tensors(chip_smoke.old_style_state(cd, 1.0e-3, n=16))
    dt = torch.tensor(DT_READS, dtype=torch.float64)
    return lambda: solve(f, dt)


def _shielded(option):
    """Chemistry 2 with the UVB and H2 self-shielding ``option``: option
    1 takes a per-cell length, option 2 a field of lengths."""
    cd = chip_smoke.answer_chem("cpu", primordial_chemistry=2,
                                UVbackground=1, H2_self_shielding=option)
    state = chip_smoke.answer_state(cd, n=16)
    if option == 2:
        state["H2_self_shielding_length"] = np.full(16, 1.0e-3)
    l_h2 = (torch.full((16,), 1.0e19, dtype=torch.float64)
            if option == 1 else None)
    return _config_solve(state=state, l_h2shield=l_h2,
                         primordial_chemistry=2, UVbackground=1,
                         H2_self_shielding=option)


def _derived_fn(which, **kw):
    cd = chip_smoke.answer_chem("cpu", **kw)
    f = _tensors(chip_smoke.tabulated_state(cd, 16)
                 if cd.primordial_chemistry == 0
                 else chip_smoke.answer_state(cd, n=16))
    fn = getattr(gfn, f"make_{which}_fn")(cd)
    return lambda: fn(f)


#: dust, metals and the UVB in comoving units at z = 1
COMOVING = dict(primordial_chemistry=3, metal_cooling=1, dust_chemistry=1,
                UVbackground=1, comoving_coordinates=1, a_value=0.5)
FLAGSHIP = dict(primordial_chemistry=3, metal_cooling=1, dust_chemistry=1)

#: every configuration the stateful API captures, beyond READ_CASES: phase
#: 2b's network configurations, old-style rank-4 and rank-5 tables, the
#: UVB, H2 self-shielding 1 to 3, comoving units, and the tabulated mode's
#: temperature (its mu fixed point)
READ_CASES.update({
    **{f"network_{name}": (lambda kw=kw: _config_solve(**kw))
       for name, kw in chip_smoke.NETWORK_CASES.items()},
    "old_style_rank4": lambda: _old_style(4),
    "old_style_rank5": lambda: _old_style(5),
    "uvb_chem1": lambda: _config_solve(primordial_chemistry=1,
                                       UVbackground=1),
    "uvb_chem2": lambda: _config_solve(primordial_chemistry=2,
                                       UVbackground=1),
    "shielding_1": lambda: _shielded(1),
    "shielding_2": lambda: _shielded(2),
    "shielding_3": lambda: _shielded(3),
    "comoving": lambda: _config_solve(**COMOVING),
    "temperature_fn_tabulated": lambda: _derived_fn(
        "temperature", primordial_chemistry=0, metal_cooling=1),
})

#: the configurations without a data-dependent loop, which read nothing
#: on the host: the exact path (in proper and comoving units) and the
#: temperature, pressure and gamma closures
NO_READ_CASES = {
    "exact": lambda: _config_solve(primordial_chemistry=0, metal_cooling=1,
                                   exact_cooling=1),
    "exact_comoving": lambda: _config_solve(
        primordial_chemistry=0, metal_cooling=1, exact_cooling=1,
        comoving_coordinates=1, a_value=0.5),
    **{f"{which}_fn_{tag}": (lambda which=which, kw=kw:
                             _derived_fn(which, **kw))
       for which in ("temperature", "pressure", "gamma")
       for tag, kw in (("flagship", FLAGSHIP), ("comoving", COMOVING))},
    "pressure_fn_tabulated": lambda: _derived_fn(
        "pressure", primordial_chemistry=0, metal_cooling=1),
    "gamma_fn_tabulated": lambda: _derived_fn(
        "gamma", primordial_chemistry=0, metal_cooling=1),
}


@pytest.mark.parametrize("case", list(READ_CASES))
def test_only_the_loop_reads(case, no_host_reads):
    run = READ_CASES[case]()
    with no_host_reads:
        run()
    assert no_host_reads.reads > 0


@pytest.mark.parametrize("case", list(NO_READ_CASES))
def test_no_loop_no_read(case, no_host_reads):
    run = NO_READ_CASES[case]()
    with no_host_reads:
        run()
    assert no_host_reads.reads == 0


class _Recorded:
    """What the graph cache uses of a captured graph: its replay."""

    def replay(self):
        pass


#: stateful calls whose body the graph cache captures, each with whether
#: its body has a loop: a solve in comoving units with the UVB (and with
#: its self-shielding, whose factors select on the photo rates), a
#: cooling time likewise, and the exact path in comoving units
STATEFUL_CASES = {
    "solve_comoving_uvb": ("solve_chemistry", COMOVING, True),
    "solve_comoving_uvb_shielded": (
        "solve_chemistry", dict(COMOVING, self_shielding_method=3), True),
    "cooling_time_comoving_uvb": ("calculate_cooling_time", COMOVING, True),
    "solve_exact_comoving": ("solve_chemistry", dict(
        primordial_chemistry=0, metal_cooling=1, exact_cooling=1,
        comoving_coordinates=1, a_value=0.5), False),
}


@pytest.mark.parametrize("case", list(STATEFUL_CASES))
def test_stateful_body_reads(case, no_host_reads, monkeypatch):
    """The body a stateful call captures, at a key's second call on a new
    a_value, reads nothing on the host but its loops' reads: the unit
    scalars and photo rates that the call computed on the host reach it
    as the scalar block, an input like the fields, and no tensor is made
    from host data inside it."""
    entry, kw, loops = STATEFUL_CASES[case]
    cd = chip_smoke.answer_chem("cpu", **kw)
    f = (chip_smoke.tabulated_state(cd, 16) if cd.primordial_chemistry == 0
         else chip_smoke.answer_state(cd, n=16))

    def capture(body, inputs):
        with no_host_reads:
            return _Recorded(), body(inputs)

    monkeypatch.setattr(graph_cache, "_on_card", lambda device: True)
    monkeypatch.setattr(graph_cache, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    args = (dict(f), DT_READS) if entry == "solve_chemistry" else (dict(f),)
    getattr(cd, entry)(*args)
    cd.a_value = 0.55
    getattr(cd, entry)(*args)
    assert cd.context.graphs.calls == {"eager": 1, "capture": 1}
    assert (no_host_reads.reads > 0) == loops


# --- a tensor dt has the bits of a float dt -----------------------------


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key])
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    else:
        assert got == want


#: every path the solve takes, with the path solve_path picks:
#: monolithic, compacted, exact, subcycled tabulated, compensated_sums
#: (on the compacted path, which packs its Neumaier pairs)
DT_PATHS = {
    "monolithic": ("monolithic", dict(primordial_chemistry=3,
                                      metal_cooling=1, dust_chemistry=1,
                                      solver_compaction=0)),
    "compacted": ("compact", dict(primordial_chemistry=2,
                                  solver_compaction=4)),
    "exact": ("exact", dict(primordial_chemistry=0, metal_cooling=1,
                            exact_cooling=1)),
    "tabulated": ("monolithic", dict(primordial_chemistry=0,
                                     metal_cooling=1, solver_compaction=0)),
    "compensated": ("compact", dict(primordial_chemistry=2,
                                    compensated_sums=1,
                                    solver_compaction=4)),
}


@pytest.mark.parametrize("precision", [64, 32])
@pytest.mark.parametrize("path", list(DT_PATHS))
def test_tensor_dt_bit_identical(path, precision, monkeypatch):
    monkeypatch.setattr(api, "_COMPACT_MIN_BUCKET", 4)
    n = 16
    want_path, kw = DT_PATHS[path]
    cd = chip_smoke.answer_chem("cpu", precision=precision, **kw)
    assert api.solve_path(cd.config, n) == want_path
    f = (chip_smoke.tabulated_state(cd, n)
         if cd.primordial_chemistry == 0
         else chip_smoke.answer_state(cd, n=n))
    dt = 1.0e-7
    want_f, want_d = cd.solve_chemistry(dict(f), dt)
    got_f, got_d = gfn.make_solve_fn(cd)(
        dict(f), torch.tensor(dt, dtype=torch.float64))
    _same(got_f, want_f)
    _same({k: got_d[k] for k in want_d}, want_d)
    # the diagnostics of the functional closure are all tensors
    assert all(isinstance(v, torch.Tensor) for v in got_d.values())


@pytest.mark.parametrize("dt", [1.0e-4, np.float32(1.0e-4),
                                torch.tensor(1.0e-4),
                                torch.tensor(1.0e-4, dtype=torch.float32)])
def test_as_dt_one_form(dt):
    """Every solve converts dt on entry to a 0-d float64 tensor on the
    fields' device, rounding nothing."""
    got = as_dt(dt, torch.zeros(3, dtype=torch.float32))
    assert got.shape == () and got.dtype == torch.float64
    assert got.item() == float(dt)
    assert as_dt(got, torch.zeros(3)) is got


@pytest.mark.parametrize("bad", [torch.ones(1), torch.ones(()) * 1j])
def test_as_dt_refuses(bad):
    with pytest.raises(ValueError, match="0-d real tensor"):
        as_dt(bad, torch.zeros(3))


@pytest.mark.parametrize("precision", [64, 32])
@pytest.mark.parametrize("case", ["chem2", "compensated"])
def test_twin_tensor_dt_bit_identical(case, precision):
    """The network region's plain twin (what the kernel is held to) on
    captured subcycle inputs, with dt a float and a 0-d tensor."""
    kw = dict(primordial_chemistry=2)
    if case == "compensated":
        kw["compensated_sums"] = 1
    cd = chip_smoke.answer_chem("cpu", precision=precision, **kw)
    dt = 1.0e-4
    for _, inp in chip_smoke.capture_network_inputs(
            cd, chip_smoke.answer_state(cd, n=64), dt, (0, 3)):
        args = (cd.context.config, inp["us"], dt, inp["f"], inp["rs"],
                inp["cool_v"], inp["carry_v"], inp["h2_limit"])
        want = network.network_update(*args)
        got = network.network_update(
            args[0], args[1], torch.tensor(dt, dtype=torch.float64),
            *args[3:])
        _same(got, want)


# --- make_solve_fn with a tensor dt against the JAX closure -------------


def test_solve_fn_steps_match_jax_scan():
    """Three steps of the closure with a 0-d tensor dt against
    ``jax.jit(lax.scan)`` over the JAX package's closure
    (tests/test_functional.py:46-73), at rtol 1e-6."""
    dt, n_steps = 0.02, 3
    jcd = jax_chem(1)
    fields = _fields_of(jax_fc(jcd, n=32, T0=1.0e5))
    jsolve = jfn.make_solve_fn(jcd)

    @jax.jit
    def evolve(f0):
        def step(f, _):
            new_f, diag = jsolve(f, dt)
            return new_f, diag["n_iterations"]
        return jax.lax.scan(step, f0, None, length=n_steps)

    want, want_it = evolve({k: jnp.asarray(v) for k, v in fields.items()})
    solve = gfn.make_solve_fn(make_chem(1))
    dt_t = torch.tensor(dt, dtype=torch.float64)
    got = _tensors(fields)
    got_it = []
    for _ in range(n_steps):
        got, diag = solve(got, dt_t)
        got_it.append(int(diag["n_iterations"]))
    assert got_it == [int(x) for x in np.asarray(want_it)]
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=0, err_msg=key)


def test_solve_fn_with_caller_op_matches_jax():
    """The closure followed by the caller's own operation (an energy
    floor), as one JAX program fuses them (tests/test_functional.py:
    76-93), against the JAX package at rtol 1e-6."""
    jcd = jax_chem(1)
    fields = _fields_of(jax_fc(jcd, n=32, T0=1.0e6))
    jsolve = jfn.make_solve_fn(jcd)

    @jax.jit
    def hydro_like_step(f, dt):
        f2, diag = jsolve(f, dt)
        return jnp.minimum(f2["energy"], f["energy"]), diag["converged"]

    want_e, want_conv = hydro_like_step(
        {k: jnp.asarray(v) for k, v in fields.items()}, 0.005)
    solve = gfn.make_solve_fn(make_chem(1))
    f = _tensors(fields)
    f2, diag = solve(f, torch.tensor(0.005, dtype=torch.float64))
    e = torch.minimum(f2["energy"], f["energy"])
    np.testing.assert_allclose(e.numpy(), np.asarray(want_e), rtol=1e-6,
                               atol=0)
    assert np.array_equal(diag["converged"].numpy(), np.asarray(want_conv))
    assert bool(diag["converged"].all())
