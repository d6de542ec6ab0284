"""The contract every hand-written kernel keeps with ops/kernel_lib.py, on
the CPU, for the network, the Cloudy, the dust and the rate kernels
alike.

The kernels build and run only on the card (chip_smoke.py phases 2 to
2d hold them to their twins bit for bit).  Here, without building
anything:

- the ctypes argument struct of each wrapper mirrors the source's,
  field for field, the network's launch grid included;
- the wrapper's slot lists follow the source's enums, and its library
  checks the slot counts and the tile or block size the source exports
  through its layout function; each entry takes Library's one signature;
- the source sits beside the wrappers and is built for sm_90a without
  fast math, the network kernel without FMA contraction, the others
  with it;
- CPU tensors run the twin and count no launch, a CUDA wrapper given
  CPU tensors raises, other devices raise, and CUDA tensors never fall
  back to the twin;
- every library is in kernel_lib's registry, whose zeroing clears every
  count.
"""

import collections
import ctypes
import dataclasses
import os
import re

import pytest
import torch

import chip_smoke
from grackle_tpu_torch.api import call_scalars
from grackle_tpu_torch.ops import cloudy_cool, cloudy_kernel, dust_kernel
from grackle_tpu_torch.ops import kernel_lib
from grackle_tpu_torch.ops import network, network_kernel, rates_kernel
from grackle_tpu_torch.ops import tabulated_temp
from grackle_tpu_torch.ops.common import block_scalars

torch.set_num_threads(1)

nk, ck, dk, rk = network_kernel, cloudy_kernel, dust_kernel, rates_kernel
#: per kernel: its wrapper module, the source's struct, the slot lists
#: by enum prefix, the source's names that the wrapper renames, the
#: source's constants the library checks and the FMA flag
KERNELS = {
    "network": (nk, "NetworkArgs",
                {"I_": nk.IN_SLOTS,
                 "O_": nk.OUT_FIELD_SLOTS + nk.OUT_CARRY_SLOTS,
                 "S_": nk.SCALAR_SLOTS},
                {**{f"s{k[1:]}": k for k in nk.SHIELD_SLOTS},
                 "cool_tgasold": "tgasold", "cool_tdust": "tdust"},
                {"TILE": nk.TILE}, "-fmad=false"),
    "cloudy": (ck, "CloudyArgs",
               {"I_": ck.IN_SLOTS, "O_": ck.OUT_SLOTS, "S_": ck.SCALAR_SLOTS,
                "D_": ck.DATA_SLOTS},
               {}, {"BLOCK": ck.BLOCK}, "-fmad=true"),
    "dust": (dk, "DustArgs", {"I_": dk.IN_SLOTS}, {}, {"BLOCK": dk.BLOCK},
             "-fmad=true"),
    "rates": (rk, "RatesArgs",
              {"I_": rk.IN_SLOTS, "S_": rk.SCALAR_SLOTS,
               "T_": rk.TABLE_SLOTS},
              {}, {"BLOCK": rk.BLOCK}, "-fmad=true"),
}
#: Library.want's key of each enum's slot count
SLOT_KEYS = {"I_": "in slots", "O_": "out slots", "S_": "scalar slots",
             "D_": "data slots", "T_": "table slots"}
_CTYPES = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
           "double": ctypes.c_double, "const void*": ctypes.c_void_p,
           "void*": ctypes.c_void_p}


def _source(module):
    with open(module.SOURCE) as fh:
        return re.sub(r"//[^\n]*", "", fh.read())


def _enums(src):
    """[the names of each enum, its N_* count last], in source order."""
    return [[n.strip() for n in body.split(",") if n.strip()]
            for body in re.findall(r"enum \w+ \{([^}]*)\}", src)]


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_args_struct_mirrors_the_source(kernel):
    module, struct = KERNELS[kernel][:2]
    src = _source(module)
    counts = {names[-1]: len(names) - 1 for names in _enums(src)}
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, name, count = re.fullmatch(
            r"((?:const )?[a-z ]+?\*?)\s+(\w+)(?:\[(\w+)\])?", decl).groups()
        typ = _CTYPES[ctype]
        fields.append((name, typ * int(counts.get(count, count))
                       if count else typ))
    args_type = module.library.args_type
    want = [("in" if name == "inp" else name, typ)
            for name, typ in args_type._fields_]
    assert [n for n, _ in fields] == [n for n, _ in want]
    for (name, got), (_, typ) in zip(fields, want):
        assert ctypes.sizeof(got) == ctypes.sizeof(typ), name
        assert getattr(got, "_type_", got) == getattr(typ, "_type_", typ), \
            name
    # passed by value as a __grid_constant__ parameter: under 4 KB
    assert ctypes.sizeof(args_type) < 4096
    if kernel == "network":
        # the launch's grid rides in the struct: one entry signature
        assert ("grid", ctypes.c_int) in fields


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_slots_follow_the_enums(kernel):
    """Each enum's names, in order, are a slot list of the wrapper's, and
    the library checks its count."""
    module, _, slots, renamed = KERNELS[kernel][:4]
    library = module.library
    enums = _enums(_source(module))
    assert sorted(names[0][:2] for names in enums) == sorted(slots)
    for names in enums:
        prefix = names[0][:2]
        assert names[-1].startswith("N_")
        got = [renamed.get(n[2:], n[2:]) for n in names[:-1]]
        assert [n[:2] for n in names[:-1]] == [prefix] * len(got)
        assert got == slots[prefix]
        assert library.want[SLOT_KEYS[prefix]] == len(got)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_layout_and_entries_match_the_source(kernel):
    """The tile or block size is the source's and a whole number of
    warps; the layout function writes one int for each value the library
    checks; every entry takes (const Args*, int is_double, void*
    stream)."""
    module, struct, slots, _, consts = KERNELS[kernel][:5]
    library = module.library
    src = _source(module)
    for name, value in consts.items():
        got = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(got) == value == library.want[name.lower()]
        assert value % 32 == 0
    assert set(library.want) == {SLOT_KEYS[p] for p in slots} | {
        name.lower() for name in consts}
    params = re.search(rf"int {library.layout}\(([^)]*)\)", src).group(1)
    assert params.count("int*") == len(library.want)
    for entry in library.entries.values():
        assert re.search(rf"int {entry}\(const {struct}\* \w+, "
                         rf"int is_double,\s+void\* stream\)", src), entry


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_source_and_flags(kernel):
    module, fmad = KERNELS[kernel][0], KERNELS[kernel][-1]
    flags = module.library.flags
    assert module.library.source == module.SOURCE
    assert os.path.isfile(module.SOURCE)
    assert os.path.dirname(module.SOURCE) == os.path.join(
        os.path.dirname(os.path.dirname(module.__file__)), "csrc")
    assert fmad in flags and "arch=compute_90a,code=sm_90a" in flags
    assert ({"-fmad=true", "-fmad=false"} - {fmad}).isdisjoint(flags)
    assert not any("fast_math" in f for f in flags)


@pytest.fixture(scope="module")
def flagship():
    """The flagship context on the CPU and its network, dust and rate
    inputs at the first subcycle, 16 cells."""
    cd = chip_smoke.flagship_chem(64, "cpu")
    fields = chip_smoke.flagship_fields(cd, 16)
    [(_, inp)] = chip_smoke.capture_network_inputs(cd, fields, 1.0e-4, (0,))
    [(_, dust_args, init)] = chip_smoke.capture_dust_inputs(
        cd, fields, 1.0e-4, (0,))
    [(_, rate_args)] = chip_smoke.capture_rate_inputs(cd, fields, 1.0e-4,
                                                      (0,))
    net_args = (cd.context.config, inp["us"], inp["dt"], inp["f"],
                inp["rs"], inp["cool_v"], inp["carry_v"], inp["h2_limit"])
    return net_args, (dust_args, {"tdust_init": init}), rate_args


@pytest.fixture(scope="module")
def tabulated():
    """The Cloudy fixed point's and cooling's arguments on the CPU (a
    tabulated context with metal cooling and the UVB; rank-3 tables)."""
    cd = chip_smoke.answer_chem("cpu", primordial_chemistry=0,
                                metal_cooling=1, UVbackground=1)
    us, _, _ = block_scalars(call_scalars(cd.context, "cpu"))
    prim, met = chip_smoke.cloudy_tables(cd)[3]
    c = chip_smoke.cloudy_cells(prim, 16, us, cd.Gamma)
    cfg = cd.context.config
    return ((prim, c["d"], c["metal"], c["e"], c["rhoH"], us.dom, us.zr,
             cfg.TemperatureStart, cfg.Gamma, us.utem, True),
            (met, c["logtem"], c["rhoH"], c["metallicity"], us.dom, us.zr,
             us.comp2, 1, 1, 1))


#: per route: its kernel's module, the router, the CUDA wrapper, the
#: launch helper below the wrapper's autograd function, and the twin
#: (module, name) the router falls to on CPU tensors
ROUTES = {"network": (nk, "network_update", "network_update_cuda",
                      "prepare_launch", network, "network_update"),
          "cloudy": (ck, "tabulated_temperature", "fixed_point_cuda",
                     "prepare_fixed_point", tabulated_temp,
                     "tabulated_temperature"),
          "cloudy cooling": (ck, "cloudy_cooling", "cooling_cuda",
                             "prepare_cooling", cloudy_cool,
                             "cloudy_cooling"),
          "dust": (dk, "dust_temperature", "dust_temperature_cuda",
                   "prepare_launch", dk, "calc_tdust_1d"),
          "rates": (rk, "rate_lookup", "rate_lookup_cuda", "prepare_launch",
                    rk, "twin")}


def _call(route, flagship, tabulated):
    net_args, dust_call, rate_args = flagship
    return {"network": (net_args, {}), "cloudy": (tabulated[0], {}),
            "cloudy cooling": (tabulated[1], {}), "dust": dust_call,
            "rates": (rate_args, {})}[route]


def _flat(out):
    """The tensors of a result (dicts, tuples and dataclasses of them)."""
    if dataclasses.is_dataclass(out):
        out = {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}
    if isinstance(out, dict):
        return [t for v in out.values() for t in _flat(v)]
    if isinstance(out, tuple):
        return [t for v in out for t in _flat(v)]
    return [] if out is None else [out]


@pytest.mark.parametrize("route", list(ROUTES))
def test_routing(route, flagship, tabulated):
    """CPU tensors run the twin and count no launch; the CUDA wrapper
    given CPU tensors raises before it builds anything; other devices
    raise."""
    module, router, wrapper, _, twin_module, twin = ROUTES[route]
    args, kw = _call(route, flagship, tabulated)
    before = module.library.issued()
    got = _flat(getattr(module, router)(*args, **kw))
    want = _flat(getattr(twin_module, twin)(*args, **kw))
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert module.library.issued() == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        getattr(module, wrapper)(*args, **kw)
    assert module.library.issued() == before
    assert not module._runs_kernel(torch.device("cpu"))
    assert module._runs_kernel(torch.device("cuda"))
    assert module._runs_kernel(torch.device("cuda", 0))
    with pytest.raises(ValueError, match="device meta"):
        module._runs_kernel(torch.device("meta"))


@pytest.mark.parametrize("option", ["compensated_sums",
                                    "use_radiative_transfer",
                                    "radiative_transfer_hydrogen_only"])
def test_network_options_reach_the_device_check(option, flagship):
    """The network kernel takes every option the Pallas kernel takes, so
    none is refused as unsupported: each reaches the device check."""
    cfg, *rest = flagship[0]
    other = dataclasses.replace(cfg, **{option: 1})
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        nk.network_update_cuda(other, *rest)


@pytest.mark.parametrize("route", list(ROUTES))
def test_cuda_never_falls_back(route, flagship, tabulated, monkeypatch):
    """Where the launch fails on CUDA tensors the router raises: the
    router, the CUDA wrapper and its autograd function stay on the path,
    only the launch helper is stood in for by one whose launch fails, and
    none of them calls the twin."""
    module, router, _, prepare, twin_module, twin = ROUTES[route]
    args, kw = _call(route, flagship, tabulated)
    prepared = []

    def failed_launch():
        raise RuntimeError(f"{module.library.what} launch failed: CUDA "
                           f"error 1")

    def prepare_failing(*a, **k):
        prepared.append(a)
        return failed_launch, None

    def fell_back(*_, **__):
        raise AssertionError("the twin ran")

    monkeypatch.setattr(module, "_runs_kernel", lambda device: True)
    monkeypatch.setattr(module, prepare, prepare_failing)
    monkeypatch.setattr(twin_module, twin, fell_back)
    with pytest.raises(RuntimeError, match="launch failed"):
        getattr(module, router)(*args, **kw)
    assert len(prepared) == 1


def test_registry(monkeypatch):
    """Every library is in kernel_lib's registry, under its own name;
    zero_counts clears every host count; count_replays arms nothing off
    the card."""
    libraries = (nk.library, ck.library, dk.library, rk.library)
    assert all(any(lib is x for x in kernel_lib.LIBRARIES)
               for lib in libraries)
    assert set(kernel_lib.executed()) == {
        "network kernel", "Cloudy kernel", "dust kernel", "rate kernel"}
    for lib in kernel_lib.LIBRARIES:
        monkeypatch.setattr(lib, "launches", collections.Counter())
        monkeypatch.setattr(lib, "recorded", collections.Counter())
        monkeypatch.setattr(lib, "_replays", kernel_lib.ReplayCounter())
        entry = next(iter(lib.entries))
        lib.launches[entry] += 3
        lib.recorded[entry] += 1
    assert all(n == 2 for n in kernel_lib.executed().values())
    kernel_lib.count_replays("cpu")
    assert all(not lib._replays._armed for lib in kernel_lib.LIBRARIES)
    kernel_lib.zero_counts()
    assert all(n == 0 for n in kernel_lib.executed().values())
    assert all(lib.issued() == 0 for lib in kernel_lib.LIBRARIES)
