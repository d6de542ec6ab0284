"""The rate lookup kernel's routing, operands, layout and backward, on the
CPU, and its parity with the twin on the card.

csrc/rate_lookup.cu runs only on the card, where chip_smoke.py phase 2e
and the card tests below hold it to its twin bit for bit.  Here:

- on CPU tensors the router returns exactly the twin's ``(RateState,
  h2_limit)``: ops/chemistry_step.py ``lookup_cool_rates`` and
  ``h2_equilibrium_limit``, as the solver called them;
- the operands a launch is given suffice: under every combination of
  chip_smoke's RATE_FLAGS (chemistry 1 to 3, dust, three_body_rate,
  H2_self_shielding 0 to 3, H2_custom_shielding, self_shielding_method 0
  to 3, radiative transfer), the twin on those operands alone, every
  other slot None, gives the twin's rows bit for bit;
- the output's rows, the argument struct's flags, geometry and pointers,
  and the launch's operand checks and bytes;
- a launch's backward is the twin's: with the launch stood in for by the
  twin on CPU tensors, the gradients through the autograd function are
  the twin's own (a per-cell input's bit for bit, a photo rate's to the
  rounding of its sum over the cells);
- the photo rates and unit scalars are read from the call's scalar block
  when the lookup runs: a block rewritten in place at another a_value
  gives that a_value's shielded rates;
- a CPU solve calls the router once a subcycle at chemistry 1 to 3 and
  never at chemistry 0.

On the card (skipped without one): the kernel equals the twin bit for bit
in f64 and f32 under every flag combination, and a CUDA graph of the
lookup replayed across two a_values gives the eager kernel's rates at
each.  The struct, slots, flags, routing and registry of every kernel:
tests/test_torch_kernel_lib.py.
"""

import dataclasses
import itertools
import math

import pytest
import torch

import chip_smoke
from grackle_tpu_torch.api import call_scalars
from grackle_tpu_torch.ops import chemistry_step as cs
from grackle_tpu_torch.ops import rates_kernel as rk
from grackle_tpu_torch.ops.common import block_scalars

torch.set_num_threads(1)

#: the cells of the recorded lookups and the subcycles recorded
N_CELLS = 32
AT = (0, 3)


def _bits(t):
    return t.view({torch.float64: torch.int64,
                   torch.float32: torch.int32}[t.dtype])


def _same(got, want):
    return len(got) == len(want) and all(
        g.shape == w.shape and torch.equal(_bits(g), _bits(w))
        for g, w in zip(got, want))


@pytest.fixture(scope="module", params=[64, 32], ids=["f64", "f32"])
def recorded(request):
    """chip_smoke phase 2e's context and state on the CPU at one
    precision, its rate lookups at AT, and their cases."""
    cd = chip_smoke.rate_chem(request.param, "cpu")
    captured = chip_smoke.capture_rate_inputs(
        cd, chip_smoke.rate_state(cd, N_CELLS), 1.0e-4, AT)
    return cd, [chip_smoke.rate_cases(args) for _, args in captured]


@pytest.mark.parametrize("chemistry", [1, 2, 3])
def test_router_is_the_twin(recorded, chemistry):
    """On CPU tensors the router gives what the solver computed before
    the kernel: lookup_cool_rates, then the H2-equilibrium limit."""
    _, per_step = recorded
    for cases in per_step:
        for flags, case in cases[::7]:
            if flags["primordial_chemistry"] != chemistry:
                continue
            cfg, tables, pr, us, f, cool, itmask, l_h2 = case
            before = rk.library.issued()
            got, limit = rk.rate_lookup(*case)
            assert rk.library.issued() == before
            want = cs.lookup_cool_rates(cfg, tables, pr, us, f, cool.tgas,
                                        cool.mmw, cool.tdust, cool.dust2gas,
                                        l_h2)
            assert got.k.keys() == want.k.keys()
            assert got.shields.keys() == want.shields.keys()
            assert got.shields["k27"] is pr.k27
            assert _same(rk.rows_of(cfg, got, limit)[:-1],
                         rk.rows_of(cfg, want, limit)[:-1])
            if chemistry == 1:
                assert limit is None
            else:
                want_limit = cs.h2_equilibrium_limit(
                    cfg, tables, want, cool, f, us, itmask)
                assert _same([limit], [want_limit])


@pytest.mark.parametrize("chemistry", [1, 2, 3])
def test_launch_operands_suffice(recorded, chemistry):
    """Under every flag combination the twin reads nothing but the
    operands a launch is given (rates_kernel.used_slots): on them alone
    it gives its rows bit for bit; and each row is a [N] tensor."""
    _, per_step = recorded
    checked = 0
    for cases in per_step:
        for flags, case in cases:
            if flags["primordial_chemistry"] != chemistry:
                continue
            cfg, tables = case[:2]
            rows = rk.rows_of(cfg, *rk.twin(*case))
            ins, scalars = rk.operands(cfg, *case[2:8])
            alone = rk.twin_rows(cfg, tables, *rk._flat(ins, scalars))
            assert all(r.shape == (N_CELLS,) for r in alone)
            assert _same(alone, rows), flags
            checked += 1
    assert checked == 2 * len(list(itertools.product(
        *chip_smoke.RATE_FLAGS.values()))) // 3


def _case(recorded, **flags):
    """The later subcycle's case under the base flags (chemistry 3, dust,
    three_body_rate 0) and ``flags``; the others 0."""
    want = dict({k: 0 for k in chip_smoke.RATE_FLAGS},
                primordial_chemistry=3, dust_chemistry=1, **flags)
    _, per_step = recorded
    return next(case for got, case in per_step[-1] if got == want)


def _cfg(recorded, **flags):
    _, per_step = recorded
    cfg = per_step[0][0][1][0]
    return dataclasses.replace(cfg, **flags)


def test_rows(recorded):
    """The rates in chemistry_step.k_names's order (the network kernel's
    K_SLOTS), the seven shield arrays, h2dust with dust, the limit at
    chemistry 2 and 3."""
    for chemistry, dust in itertools.product((1, 2, 3), (0, 1)):
        cfg = _cfg(recorded, primordial_chemistry=chemistry,
                   dust_chemistry=dust, h2_on_dust=0)
        names = cs.k_names(cfg)
        assert names == rk.K_SLOTS[:len(names)]
        assert rk.row_names(cfg) == (
            names + cs.SHIELD_ARRAYS + ["h2dust"] * dust
            + ["h2_limit"] * (chemistry > 1))
        assert rk.TABLE_SLOTS[:len(names)] == names
    assert rk.TABLE_SLOTS.index("k13") == 14
    assert rk.TABLE_SLOTS.index("k22") == 21
    with pytest.raises(ValueError, match="primordial_chemistry = 0"):
        rk.used_slots(_cfg(recorded, primordial_chemistry=0))


def test_struct(recorded):
    """The struct carries the flags, the geometry the twin's table_index
    forms on the host, the constants, and a pointer exactly where one is
    named."""
    cfg = _cfg(recorded, primordial_chemistry=3, dust_chemistry=1,
               H2_self_shielding=2, self_shielding_method=3,
               use_radiative_transfer=1, H2_custom_shielding=1)
    dtype = recorded[0].context.tables.k1.dtype
    args = rk.struct(cfg, 7, dtype, {"table": {"k1": 11, "h2dust": 12},
                                     "scalar": {"dom": 13},
                                     "inp": {"itmask": 14}, "out": 15})
    assert (args.n, args.ispecies, args.anydust, args.three_body_rate) == (
        7, 3, 1, cfg.three_body_rate)
    assert (args.h2_self_shielding, args.h2_custom_shielding,
            args.self_shielding_method, args.rt) == (2, 1, 3, 1)
    assert args.n_bins == cfg.NumberOfTemperatureBins
    assert args.logt0 == math.log(cfg.TemperatureStart)
    assert args.dlogt == (math.log(cfg.TemperatureEnd)
                          - math.log(cfg.TemperatureStart)) / (
        cfg.NumberOfTemperatureBins - 1)
    assert args.eq_step == 0.1 * args.dlogt
    assert args.logd9 == math.log(cfg.DustTemperatureEnd)
    tiny8 = 1.0e-40 if dtype == torch.float64 else 1.0e-37
    assert (args.tiny8, args.fh, args.acc) == (
        tiny8, cfg.HydrogenFractionByMass, cfg.subcycle_accuracy)
    assert [args.table[i] for i in range(rk.N_TABLE)] == [
        {"k1": 11, "h2dust": 12}.get(k) for k in rk.TABLE_SLOTS]
    assert [args.scalar[i] for i in range(rk.N_SCALAR)] == [
        13 if k == "dom" else None for k in rk.SCALAR_SLOTS]
    assert [args.inp[i] for i in range(rk.N_IN)] == [
        14 if k == "itmask" else None for k in rk.IN_SLOTS]
    assert args.out == 15
    # chemistry 1 has no H2 shielding, whatever the option says
    assert rk.struct(_cfg(recorded, primordial_chemistry=1,
                          H2_self_shielding=3), 1, dtype,
                     {}).h2_self_shielding == 0


def test_prepare_launch(recorded, monkeypatch):
    """With the device check stood aside, on CPU tensors: every operand,
    scalar and table the configuration reads is checked and pointed to,
    the unused slots stay null, and the launch's bytes are its operands'
    and its output's; a missing or mistyped operand is refused."""
    case = _case(recorded, H2_self_shielding=2, H2_custom_shielding=1,
                 self_shielding_method=3, use_radiative_transfer=1)
    cfg, tables = case[:2]
    ins, scalars = rk.operands(cfg, *case[2:8])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rk.prepare_launch(cfg, tables, ins, scalars)
    monkeypatch.setattr(rk.library, "require_cuda", lambda device: None)
    launch, out = rk.prepare_launch(cfg, tables, ins, scalars)
    assert out.shape == (len(rk.row_names(cfg)), N_CELLS)
    assert out.dtype == ins["tgas"].dtype
    assert launch.bytes == (sum(t.nbytes for t in ins.values())
                            + sum(t.nbytes for t in scalars.values())
                            + out.nbytes)
    want_in, want_scalar, want_table = rk.used_slots(cfg)
    assert set(ins) == want_in and set(scalars) == want_scalar
    assert {"k13dd", "h2dust"} <= want_table
    bad = dict(ins, tgas=ins["tgas"].to(torch.float16))
    with pytest.raises((ValueError, TypeError)):
        rk.prepare_launch(cfg, tables, bad, scalars)
    missing = {k: v for k, v in ins.items() if k != "H2I"}
    with pytest.raises(ValueError, match="operands"):
        rk.prepare_launch(cfg, tables, missing, scalars)
    strided = dict(ins, edot=torch.stack([ins["edot"]] * 2, 1)[:, 0])
    with pytest.raises(ValueError, match="operand edot"):
        rk.prepare_launch(cfg, tables, strided, scalars)
    wide = dict(scalars, dom=scalars["dom"].reshape(1))
    with pytest.raises(ValueError, match="scalar dom"):
        rk.prepare_launch(cfg, tables, ins, wide)


def test_backward_is_the_twins(recorded, monkeypatch):
    """The launch stood in for by the twin on CPU tensors: the gradients
    through the autograd function, with respect to a per-cell operand and
    a field, are the twin's own, bit for bit, also where the caller leaves
    a row out; with respect to a photo rate, to the rounding of its sum
    over the cells."""
    cfg, tables, pr, us, f, cool, itmask, l_h2 = _case(
        recorded, H2_self_shielding=3, use_radiative_transfer=1)

    def stand_in(cfg, tables, ins, scalars):
        flat = rk._flat(ins, scalars)
        out = torch.empty((len(rk.row_names(cfg)), N_CELLS),
                          dtype=ins["tgas"].dtype)

        def launch():
            out.copy_(torch.stack(rk.twin_rows(cfg, tables, *flat)))

        return launch, out

    monkeypatch.setattr(rk, "prepare_launch", stand_in)
    grads = []
    for fn in (rk.rate_lookup_cuda, rk.twin):
        tgas = cool.tgas.clone().requires_grad_(True)
        h2i = f["H2I"].clone().requires_grad_(True)
        k24 = pr.k24.clone().requires_grad_(True)
        cool_x = type(cool)(**dict(vars(cool), tgas=tgas))
        out = fn(cfg, tables, dataclasses.replace(pr, k24=k24), us,
                 dict(f, H2I=h2i), cool_x, itmask, l_h2)
        # every row but the limit's (its unselected branch is not finite
        # everywhere)
        rows = rk.rows_of(cfg, *out)[:-1]
        weights = torch.linspace(0.5, 2.0, len(rows), dtype=tgas.dtype)
        total = sum(w * r.sum() for w, r in zip(weights, rows))
        total.backward()
        grads.append([tgas.grad, h2i.grad, k24.grad])
    (tgas, h2i, k24), (twin_tgas, twin_h2i, twin_k24) = grads
    assert _same([tgas, h2i], [twin_tgas, twin_h2i])
    # the photo rate's is a sum over the cells, which the two graphs
    # reduce in their own order
    assert torch.allclose(k24, twin_k24, atol=0.0,
                          rtol=32 * torch.finfo(k24.dtype).eps)
    assert all(bool(torch.isfinite(g).all()) for g in grads[0])


def test_scalars_are_read_when_the_lookup_runs(recorded):
    """The twin reads the photo rates and unit scalars from the call's
    scalar block: a block rewritten in place at another a_value gives
    that a_value's shielded rates, which differ from the first's."""
    cd, _ = recorded
    cfg, tables, _, _, f, cool, itmask, l_h2 = _case(
        recorded, H2_self_shielding=3, self_shielding_method=3)
    ctx, a_start = cd.context, cd.a_value

    def block_at(a_value):
        cd.a_value = a_value
        cd.refresh_units()
        return call_scalars(ctx, "cpu")

    block = block_at(0.5)
    us, pr, _ = block_scalars(block)
    first = rk.rows_of(cfg, *rk.rate_lookup(cfg, tables, pr, us, f, cool,
                                            itmask, l_h2))
    later = block_at(0.3)
    block.copy_(later)
    got = rk.rows_of(cfg, *rk.rate_lookup(cfg, tables, pr, us, f, cool,
                                          itmask, l_h2))
    us2, pr2, _ = block_scalars(later)
    want = rk.rows_of(cfg, *rk.rate_lookup(cfg, tables, pr2, us2, f, cool,
                                           itmask, l_h2))
    block_at(a_start)
    assert _same(got, want)
    k24 = rk.row_names(cfg).index("k24")
    assert not torch.equal(got[k24], first[k24])


@pytest.mark.parametrize("chemistry", [0, 1, 3])
def test_a_cpu_solve_looks_up_once_a_subcycle(chemistry, monkeypatch):
    """A CPU solve calls the router once a subcycle at chemistry 1 to 3,
    and never at chemistry 0; it runs the twin and launches nothing."""
    cd = chip_smoke.answer_chem("cpu", primordial_chemistry=chemistry,
                                metal_cooling=1)
    calls = []
    route = rk.rate_lookup

    def counted(*args):
        calls.append(args[0].primordial_chemistry)
        return route(*args)

    monkeypatch.setattr(rk, "rate_lookup", counted)
    before = rk.library.issued()
    _, diag = cd.solve_chemistry(chip_smoke.answer_state(cd, n=8), 1.0e-4)
    assert rk.library.issued() == before
    assert len(calls) == (int(diag["subcycles"]) if chemistry else 0)
    assert set(calls) <= {chemistry}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: csrc/rate_lookup.cu runs only on the "
                    "card (chip_smoke.py phase 2e holds it there too)")


@pytest.mark.parametrize("precision", [64, 32])
def test_card_kernel_is_the_twin(precision):
    """On the card, under every flag combination, at two subcycles: the
    kernel's rows equal the twin's bit for bit."""
    _card()
    cd = chip_smoke.rate_chem(precision, "cuda")
    captured = chip_smoke.capture_rate_inputs(
        cd, chip_smoke.rate_state(cd, 1000), 1.0e-4, AT)
    for _, args in captured:
        for flags, case in chip_smoke.rate_cases(args):
            got = chip_smoke.rate_rows(case[0], rk.rate_lookup_cuda(*case))
            want = chip_smoke.rate_rows(case[0], rk.twin(*case))
            assert chip_smoke.cloudy_bit_differences(got, want)[0] == 0, \
                flags


def test_card_replay_across_a_values():
    """A CUDA graph of the lookup, replayed after the scalar block is
    rewritten at another a_value, gives the eager kernel's and the
    twin's rows at that a_value, whose shielded rates differ."""
    _card()
    cd = chip_smoke.rate_chem(64, "cuda")
    [(_, args)] = chip_smoke.capture_rate_inputs(
        cd, chip_smoke.rate_state(cd, 1000), 1.0e-4, (0,))
    flags, case = chip_smoke.rate_cases(args)[-1]
    cfg, tables, _, _, f, cool, itmask, l_h2 = case

    def block_at(a_value):
        cd.a_value = a_value
        cd.refresh_units()
        return call_scalars(cd.context, "cuda")

    block = block_at(0.25)
    us, pr, _ = block_scalars(block)

    def lookup():
        return rk.rate_lookup(cfg, tables, pr, us, f, cool, itmask, l_h2)

    lookup()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = lookup()
    rows = []
    for a_value in (0.25, 0.3):
        block.copy_(block_at(a_value))
        graph.replay()
        torch.cuda.synchronize()
        got = chip_smoke.rate_rows(cfg, captured)
        want = chip_smoke.rate_rows(cfg, rk.twin(
            cfg, tables, pr, us, f, cool, itmask, l_h2))
        assert chip_smoke.cloudy_bit_differences(got, want)[0] == 0
        assert chip_smoke.cloudy_bit_differences(
            got, chip_smoke.rate_rows(cfg, lookup()))[0] == 0
        rows.append([r.clone() for r in got])
    k24 = rk.row_names(cfg).index("k24")
    assert not torch.equal(rows[0][k24], rows[1][k24])
