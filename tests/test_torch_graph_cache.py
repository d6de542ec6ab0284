"""grackle_tpu_torch's graph cache (graph_cache.py) on the CPU.

The stateful entry points capture a CUDA graph at the second call with a
key and replay it after, as the JAX package's are jitted.  Here a
stand-in for ``torch.cuda.CUDAGraph`` takes the graph's place: its
capture records the body and the static buffers it was given (and
poisons the outputs, which a real capture leaves unwritten), and its
replay re-runs the body on those buffers, writing into the capture's
outputs as a replay overwrites a graph's.  So the cache's key, its
copy-in and clone-out, its capture-on-second-call rule, its bound and
its bypasses run here; chip_smoke.py phase 4n runs them with real graphs
on the card.

- three successive stateful flagship calls (eager, capture, replay),
  each with new inputs and a new dt, against the JAX package's
  ``solve_chemistry`` at rtol 1e-6 (tests/test_answers.py's tolerance),
  the first call's results unchanged after the third;
- a cosmological run: four flagship calls in comoving units with the
  UVB, each at a new ``a_value``, under one key (eager, capture,
  replay, replay), each against the JAX package at that ``a_value``;
- a changed ``a_value`` or ``grid_dx`` replays the entry it has, a
  changed comoving flag makes a new one;
- a second call whose capture would not fit in the card's free memory
  stays eager, and captures once the memory is there;
- the least recently used graph goes at the bound, which counts every
  context's graphs on the card, and a key that would drop a graph used
  since its own last call stays eager;
- calls whose fields come in different orders share one graph, each
  field copied into its own buffer;
- an input that requires grad, and a call while the stream captures,
  bypass the cache; the CPU never captures;
- no call's result aliases its inputs on the exact path.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu.api import ChemistryData as JChemistryData
from grackle_tpu.ops import lookup as jlookup
from grackle_tpu_torch import api, graph_cache
from tests.answer_workloads import _data_file
from tests.test_torch_network import UNIT_ATTRS, jax_context_as_port

torch.set_num_threads(1)


def _refill(out, new):
    """Write ``new`` into ``out`` in place (tensors) or by key (the rest),
    as a replay rewrites a graph's outputs."""
    if isinstance(out, torch.Tensor):
        out.copy_(new)
    elif isinstance(out, dict):
        for key in out:
            if isinstance(out[key], (torch.Tensor, dict, tuple)):
                _refill(out[key], new[key])
            else:
                out[key] = new[key]
    else:
        for o, n in zip(out, new):
            _refill(o, n)


def _poison(out, inputs):
    """NaN in every float output that is not one of the static inputs
    (which the body may hand back): what a capture leaves unwritten."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() and not _storages(out) & inputs:
            out.fill_(float("nan"))
    elif isinstance(out, (dict, tuple)):
        for val in (out.values() if isinstance(out, dict) else out):
            _poison(val, inputs)


class StandInGraph:
    """What the cache uses of a captured ``torch.cuda.CUDAGraph``, on the
    CPU: ``replay()`` re-runs the captured body on the static buffers
    and writes into the capture's outputs."""

    def __init__(self, body, inputs):
        self.body, self.inputs = body, inputs
        self.outputs = body(inputs)
        _poison(self.outputs, _storages(inputs))
        self.replays = 0

    def replay(self):
        _refill(self.outputs, self.body(self.inputs))
        self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
    """CPU tensors take the cache's graph path with StandInGraph for the
    CUDA graph; returns the list of graphs captured."""
    captured = []

    def capture(body, inputs):
        graph = StandInGraph(body, inputs)
        captured.append(graph)
        return graph, graph.outputs

    monkeypatch.setattr(graph_cache, "_on_card", lambda device: True)
    monkeypatch.setattr(graph_cache, "_capture", capture)
    # the bound is the card's: count only the caches this test makes
    monkeypatch.setattr(graph_cache, "_caches", weakref.WeakSet())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return captured


def _storages(tree):
    if isinstance(tree, torch.Tensor):
        return {tree.untyped_storage().data_ptr()}
    vals = tree.values() if isinstance(tree, dict) else tree
    return set().union(*(_storages(v) for v in vals
                         if isinstance(v, (torch.Tensor, dict, tuple))))


def _tensors(fields):
    return {k: torch.as_tensor(v) for k, v in fields.items()}


def _call(graphs, fn, *args, **kw):
    """``fn(*args, **kw)`` and the kind of call the cache made of it."""
    before = graphs.calls.copy()
    out = fn(*args, **kw)
    [kind] = graphs.calls - before
    return kind, out


# --- three flagship calls against the JAX package -----------------------


#: (state seed, dt) of the three calls: short steps of 48 to 160 subcycles
FLAGSHIP_CALLS = ((11, 1.0e-8), (12, 3.0e-8), (13, 2.0e-8))
N_FLAGSHIP = 64


@pytest.fixture(scope="module")
def jax_flagship():
    """The JAX package's flagship (BASELINE config 4) on the gather path,
    its solve of each state of FLAGSHIP_CALLS, and its context carried
    over to the port (identical tables)."""
    jcd = JChemistryData()
    for k, v in dict(UNIT_ATTRS, use_grackle=1, with_radiative_cooling=1,
                     precision=64, use_fused_lookup=0,
                     primordial_chemistry=3, metal_cooling=1,
                     dust_chemistry=1, cmb_temperature_floor=1,
                     grackle_data_file=_data_file()).items():
        setattr(jcd, k, v)
    # the f32 splits of the fused TPU lookup are unused on the gather path
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlookup, "pair_split", lambda mat: None)
        assert jcd.initialize() == 1
    recipe = chip_smoke.flagship_chem(64, "cpu")
    calls = []
    for seed, dt in FLAGSHIP_CALLS:
        fields = chip_smoke.flagship_fields(recipe, N_FLAGSHIP, seed=seed)
        new_f, diag = jcd.solve_chemistry(dict(fields), dt)
        calls.append((fields, dt, {k: np.asarray(v)
                                   for k, v in new_f.items()},
                      np.asarray(diag["cell_iterations"])))
    return jax_context_as_port(jcd), calls


def test_three_calls_match_jax(jax_flagship, stand_in):
    """Eager, capture and replay, each with new inputs and a new dt,
    against the JAX package at rtol 1e-6 with the same per-cell
    subcycles; the capture read static buffers, never the caller's
    tensors; the first call's results are unchanged after the third."""
    ctx, calls = jax_flagship
    results, kinds, inputs = [], [], []
    for fields, dt, want_f, want_it in calls:
        given = _tensors(fields)
        inputs.append(given)
        kind, (got_f, got_d) = _call(ctx.graphs, api.solve_chemistry, ctx,
                                     given, dt)
        kinds.append(kind)
        assert isinstance(got_d["subcycles"], int)
        assert isinstance(got_d["trips"], int)
        np.testing.assert_array_equal(got_d["cell_iterations"].numpy(),
                                      want_it)
        assert sorted(got_f) == sorted(want_f)
        for key in want_f:
            np.testing.assert_allclose(got_f[key].numpy(), want_f[key],
                                       rtol=1e-6, atol=0, err_msg=key)
        assert not _storages((got_f, got_d)) & _storages(given)
        results.append((got_f, got_d))
    assert kinds == ["eager", "capture", "replay"]
    assert len(ctx.graphs) == 1 and len(stand_in) == 1
    [graph] = stand_in
    assert graph.replays == 2
    assert not _storages(graph.inputs) & _storages(inputs)
    assert not _storages(graph.outputs) & _storages(results[1:])
    first_f, first_d = results[0]
    _, _, want_f, want_it = calls[0]
    np.testing.assert_array_equal(first_d["cell_iterations"].numpy(),
                                  want_it)
    for key in want_f:
        np.testing.assert_allclose(first_f[key].numpy(), want_f[key],
                                   rtol=1e-6, atol=0, err_msg=key)
    second_f, _ = results[1]
    _, _, want_f, _ = calls[1]
    for key in want_f:
        np.testing.assert_allclose(second_f[key].numpy(), want_f[key],
                                   rtol=1e-6, atol=0, err_msg=key)


# --- a cosmological run: one key whatever the a_value -------------------


#: the expansion factors of the cosmological calls (z = 1 to 0.89, the
#: UVB on), each call's state seed and dt
COSMO_CALLS = ((0.50, 21, 1.0e-8), (0.51, 22, 2.0e-8), (0.52, 23, 1.0e-8),
               (0.53, 24, 3.0e-8))


@pytest.fixture(scope="module")
def jax_cosmological():
    """The JAX package's flagship in comoving units with the UVB from the
    data file that ``jax_flagship`` reads, its solve at each a_value of
    COSMO_CALLS (units refreshed each time, as a cosmological host does),
    and its context carried over to the port."""
    jcd = JChemistryData()
    for k, v in dict(UNIT_ATTRS, use_grackle=1, with_radiative_cooling=1,
                     precision=64, use_fused_lookup=0,
                     primordial_chemistry=3, metal_cooling=1,
                     dust_chemistry=1, cmb_temperature_floor=1,
                     UVbackground=1, comoving_coordinates=1, a_units=1.0,
                     a_value=COSMO_CALLS[0][0],
                     grackle_data_file=_data_file()).items():
        setattr(jcd, k, v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlookup, "pair_split", lambda mat: None)
        assert jcd.initialize() == 1
    ctx = jax_context_as_port(jcd)
    recipe = chip_smoke.flagship_chem(64, "cpu")
    calls = []
    for a_value, seed, dt in COSMO_CALLS:
        jcd.a_value = a_value
        jcd.refresh_units()
        fields = chip_smoke.flagship_fields(recipe, N_FLAGSHIP, seed=seed)
        new_f, diag = jcd.solve_chemistry(dict(fields), dt)
        calls.append((a_value, fields, dt,
                      {k: np.asarray(v) for k, v in new_f.items()},
                      np.asarray(diag["cell_iterations"])))
    return ctx, calls


def test_cosmological_run_replays_one_graph(jax_cosmological, stand_in):
    """A cosmological host: every call at a new a_value, the units
    refreshed before it.  The unit scalars and the UVB photo rates reach
    the body through the call's scalar block, so the calls are eager,
    capture, replay, replay under one key, as the JAX package compiles
    its core once; each call within rtol 1e-6 of the JAX package at its
    a_value, with the same per-cell subcycles."""
    ctx, calls = jax_cosmological
    kinds = []
    for a_value, fields, dt, want_f, want_it in calls:
        ctx.units = dataclasses.replace(ctx.units, a_value=a_value)
        kind, (got_f, got_d) = _call(ctx.graphs, api.solve_chemistry, ctx,
                                     _tensors(fields), dt)
        kinds.append(kind)
        np.testing.assert_array_equal(got_d["cell_iterations"].numpy(),
                                      want_it, err_msg=str(a_value))
        for key in want_f:
            np.testing.assert_allclose(got_f[key].numpy(), want_f[key],
                                       rtol=1e-6, atol=0,
                                       err_msg=f"{a_value} {key}")
    assert kinds == ["eager", "capture", "replay", "replay"]
    assert len(ctx.graphs) == 1 and len(stand_in) == 1
    assert stand_in[0].replays == 3


# --- the key --------------------------------------------------------------


def _chem1(**kw):
    return chip_smoke.answer_chem("cpu", primordial_chemistry=1, **kw)


@pytest.mark.parametrize("change", ["a_value", "grid_dx",
                                    "comoving_coordinates"])
def test_changed_units_make_a_new_entry(change, stand_in):
    """A changed a_value (a cosmological run's next step) or grid_dx
    reaches the graph through the call's scalar block: the call replays
    the entry it has, bit-identical to a fresh uncached solve at the new
    units (a new a_value moves the results).  The comoving flag changes
    what the body does and is static to the JAX package's cores too: a
    changed flag is a new key, eager first, captured at its second call;
    the old graph stays."""
    cd = _chem1()
    fields = _tensors(chip_smoke.answer_state(cd, n=8))

    def solve(**kw):
        return _call(cd.context.graphs, cd.solve_chemistry, dict(fields),
                     1.0e-9, **kw)

    kinds, outs = zip(*[solve() for _ in range(3)])
    assert list(kinds) == ["eager", "capture", "replay"]
    first_f, _ = outs[0]
    kw = {}
    if change == "a_value":
        cd.a_value = 0.5
    elif change == "grid_dx":
        kw["grid_dx"] = 1.0e-3
    else:
        cd.comoving_coordinates = 1
    kind, (new_f, _) = solve(**kw)
    with chip_smoke.uncached():
        want_f, _ = cd.solve_chemistry(dict(fields), 1.0e-9, **kw)
    for key in want_f:
        assert torch.equal(new_f[key], want_f[key]), key
    if change == "a_value":
        assert not torch.equal(new_f["energy"], first_f["energy"])
    if change != "comoving_coordinates":
        assert kind == "replay" and len(cd.context.graphs) == 1
        return
    assert kind == "eager" and len(cd.context.graphs) == 1
    kind, (again_f, _) = solve(**kw)
    assert kind == "capture" and len(cd.context.graphs) == 2
    for key in new_f:
        assert torch.equal(again_f[key], new_f[key]), key
    assert [key[0][4] for key in cd.context.graphs.keys()] == [False, True]


def test_capture_that_does_not_fit_stays_eager(stand_in, monkeypatch):
    """A key's second call whose capture would not fit in the card's free
    memory (the query patched to report none) stays eager, counted so,
    with the uncached body's results; once the memory is there the next
    call captures and replays."""
    cd = _chem1()
    fields = _tensors(chip_smoke.answer_state(cd, n=8))
    with chip_smoke.uncached():
        want_f, _ = cd.solve_chemistry(dict(fields), 1.0e-9)
    free = [0]
    monkeypatch.setattr(graph_cache, "_free_bytes", lambda device: free[0])
    kinds = []
    for call in range(5):
        if call == 3:
            free[0] = float("inf")
        kind, (got_f, _) = _call(cd.context.graphs, cd.solve_chemistry,
                                 dict(fields), 1.0e-9)
        kinds.append(kind)
        for key in want_f:
            assert torch.equal(got_f[key], want_f[key]), (call, key)
    assert kinds == ["eager", "eager", "eager", "capture", "replay"]
    assert cd.context.graphs.calls == {"eager": 3, "capture": 1,
                                       "replay": 1}


def test_least_recently_used_dropped_at_the_bound(stand_in, monkeypatch):
    """With a bound of 2: a third width's capture drops the least
    recently used graph; a dropped key starts again with an eager call;
    every result equals the eager body's."""
    cd = _chem1()
    graphs = cd.context.graphs
    monkeypatch.setattr(graph_cache, "MAX_GRAPHS", 2)
    state = _tensors(chip_smoke.answer_state(cd, n=8))
    eager = {}

    def temperature(width):
        kind, out = _call(graphs, cd.calculate_temperature,
                          {k: v[:width] for k, v in state.items()})
        assert len(graphs) <= graph_cache.MAX_GRAPHS
        if kind == "eager":
            eager.setdefault(width, out)
        assert torch.equal(out, eager[width])
        return kind

    def widths():
        return [dict(key[0][1])["density"][0] for key in graphs.keys()]

    assert [temperature(w) for w in (4, 4, 5, 5)] == [
        "eager", "capture", "eager", "capture"]
    assert widths() == [4, 5]
    assert [temperature(6), temperature(6)] == ["eager", "capture"]
    assert widths() == [5, 6]
    assert temperature(5) == "replay" and widths() == [6, 5]
    assert [temperature(4), temperature(4)] == ["eager", "capture"]
    assert widths() == [5, 4]


def test_field_order_does_not_matter(stand_in):
    """The key sorts the field names, so calls whose fields come in
    different orders share one graph: the inputs are copied in by name.
    The solver returns its fields in another order than it is given
    them, so a host that feeds results back in changes the order: eager
    in the caller's order, captured in the solver's output order,
    replayed in the caller's order again, each equal to the uncached
    body bit for bit."""
    cd = _chem1()
    state = _tensors(chip_smoke.answer_state(cd, n=8))
    swapped = dict(reversed(list(state.items())))
    assert list(swapped) != list(state)
    calls = [(state, 1.0e-9), (swapped, 2.0e-9),
             ({k: v * 1.01 for k, v in state.items()}, 3.0e-9)]
    kinds = []
    for fields, dt in calls:
        kind, (got_f, got_d) = _call(cd.context.graphs, cd.solve_chemistry,
                                     fields, dt)
        kinds.append(kind)
        with chip_smoke.uncached():
            want_f, want_d = cd.solve_chemistry(fields, dt)
        assert sorted(got_f) == sorted(want_f)
        for key in want_f:
            assert torch.equal(got_f[key], want_f[key]), key
        assert torch.equal(got_d["cell_iterations"],
                           want_d["cell_iterations"])
    assert kinds == ["eager", "capture", "replay"]


def test_bound_is_the_cards(stand_in, monkeypatch):
    """The bound counts every context's graphs on the device: a second
    context's capture drops the first context's least recently used
    graph."""
    monkeypatch.setattr(graph_cache, "MAX_GRAPHS", 2)
    first, second = _chem1(), _chem1()
    state = _tensors(chip_smoke.answer_state(first, n=8))

    def temperature(cd, width):
        return _call(cd.context.graphs, cd.calculate_temperature,
                     {k: v[:width] for k, v in state.items()})[0]

    assert [temperature(first, w) for w in (4, 4, 5, 5)] == [
        "eager", "capture", "eager", "capture"]
    assert [temperature(second, 4), temperature(second, 4)] == [
        "eager", "capture"]
    assert graph_cache.held("cpu") == 2
    assert len(first.context.graphs) == len(second.context.graphs) == 1
    assert temperature(first, 5) == "replay"
    assert temperature(first, 4) == "eager"
    # a context's graphs go with it (the stand-ins hold their bodies,
    # and so their contexts, in the fixture's list)
    del second
    stand_in.clear()
    gc.collect()
    assert graph_cache.held("cpu") == 1


def test_more_widths_than_the_bound(stand_in, monkeypatch):
    """A host cycling through more widths than the bound: the widths
    that fit replay, and the ones whose capture would drop a graph used
    since their last call stay eager, rather than every call capturing
    and dropping the graph that comes next; each result equals the
    uncached body's."""
    monkeypatch.setattr(graph_cache, "MAX_GRAPHS", 2)
    cd = _chem1()
    state = _tensors(chip_smoke.answer_state(cd, n=8))
    rounds = []
    for _ in range(4):
        kinds = []
        for width in (4, 5, 6):
            fields = {k: v[:width] for k, v in state.items()}
            kind, out = _call(cd.context.graphs, cd.calculate_temperature,
                              fields)
            with chip_smoke.uncached():
                assert torch.equal(out, cd.calculate_temperature(fields))
            kinds.append(kind)
        rounds.append(kinds)
    assert rounds == [["eager"] * 3, ["capture", "capture", "eager"],
                      ["replay", "replay", "eager"],
                      ["replay", "replay", "eager"]]


# --- what bypasses the cache ---------------------------------------------


@pytest.mark.parametrize("case", ["requires_grad", "capturing", "cpu"])
def test_bypasses(case, request, monkeypatch):
    """An input that requires grad (a graph records no autograd), a call
    made while the current stream captures (a host capturing the call
    into its own graph) and the CPU itself run every call eagerly and
    leave the cache untouched."""
    if case != "cpu":
        request.getfixturevalue("stand_in")
    if case == "capturing":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    cd = _chem1()
    fields = _tensors(chip_smoke.answer_state(cd, n=8))
    if case == "requires_grad":
        fields["energy"].requires_grad_(True)
        outs = [cd.calculate_temperature(fields) for _ in range(3)]
        outs[-1].sum().backward()
        assert fields["energy"].grad is not None
    else:
        outs = [cd.solve_chemistry(dict(fields), 1.0e-9)[0]["energy"]
                for _ in range(3)]
    assert len(cd.context.graphs) == 0
    assert not cd.context.graphs.calls
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_exact_outputs_do_not_alias_inputs(stand_in):
    """The exact path hands back the fields it does not change; on every
    kind of call the results are fresh tensors: a hydro loop that writes
    to the fields it passed, then feeds the results back in, leaves
    every result as it was returned."""
    cd = chip_smoke.answer_chem("cpu", primordial_chemistry=0,
                                metal_cooling=1, exact_cooling=1)
    assert api.solve_path(cd.config, 8) == "exact"
    fields = _tensors(chip_smoke.tabulated_state(cd, 8))
    kinds = []
    for _ in range(3):
        kind, (new_f, _) = _call(cd.context.graphs, cd.solve_chemistry,
                                 fields, 1.0e-9)
        kinds.append(kind)
        assert not _storages(new_f) & _storages(fields)
        kept = {k: v.clone() for k, v in new_f.items()}
        for val in fields.values():
            val.mul_(2.0)
        for key in kept:
            assert torch.equal(new_f[key], kept[key]), key
        fields = new_f
    assert kinds == ["eager", "capture", "replay"]
