"""The rate lookup of the subcycle body and its H2-equilibrium limit as one
hand-written CUDA launch, and their routing.

:func:`rate_lookup` is what ``ops/solver.subcycle`` calls at
primordial_chemistry 1 to 3.  It returns ``(RateState, h2_limit)``.  On
CPU tensors it runs the plain twin (:func:`twin`:
ops/chemistry_step.py ``lookup_cool_rates``, then its
``h2_equilibrium_limit`` at chemistry 2 and 3); on CUDA tensors it
launches csrc/rate_lookup.cu, one launch a call, or raises.  There is no
fallback from the card to the twin.  The kernel takes every option the
twin takes (chemistry 1 to 3, dust, ``three_body_rate``, the four
``H2_self_shielding`` options, ``H2_custom_shielding``, the three
``self_shielding_method`` options, radiative transfer): the flags ride
in its argument struct.

The launch writes one ``(rows, N)`` tensor in the solver dtype
(:func:`row_names`): the rates of ``chemistry_step.k_names``, the seven
shield arrays, h2dust where the configuration has dust and the
H2-equilibrium limit at chemistry 2 and 3.  The returned ``RateState``'s
``k``, ``shields`` and ``h2dust``, and ``h2_limit``, are its rows, which
the network kernel reads as they are; ``shields["k27"]`` is the call's
unshielded 0-d rate, and ``k13dd`` and ``ti`` are None (nothing after
the lookup reads them).  The photo rates and unit scalars are read
through pointers into the call's scalar block, so a graph replays with a
new ``a_value`` and new photo rates.

The library is built at first use (the first chemistry >= 1 solve on the
card) with ``nvcc`` for sm_90a from the source in this package, into
``grackle_tpu_torch/_build/``, loaded with ctypes and launched on
PyTorch's current stream, so a CUDA-graph capture records it
(ops/kernel_lib.Library, with its POW_FLAGS).  Each launch is an
autograd function whose backward recomputes the twin and returns its
vector-Jacobian product.

``library`` counts the launches: those issued on the host, and where its
``count_replays`` armed the device before a capture, those that graphs
replayed, counted on the card (ops/kernel_lib.Library).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import types

import torch
from torch.autograd.function import once_differentiable

from ..constants import kboltz, mass_h
from . import chemistry_step as cs
from .common import dtype_huge8, dtype_tiny8
from .kernel_lib import (PKG_DIR, POW_FLAGS, Library, runs_kernel,
                         save_twin_args, twin_vjp)
from .network_kernel import K_SLOTS

SOURCE = os.path.join(PKG_DIR, "csrc", "rate_lookup.cu")
#: the kernel calls CUDA's pow, exp, log10 and sqrt
NVCC_FLAGS = POW_FLAGS
#: threads a CTA, one cell each: csrc/rate_lookup.cu's BLOCK
BLOCK = 128

#: the fields of the solver's field dict that the lookup reads
FIELD_SLOTS = ["density", "HI", "HII", "HeI", "HeII", "HeIII", "HM", "H2I",
               "H2II", "DI", "DII", "HDI", "RT_H2_dissociation_rate",
               "H2_self_shielding_length"]
#: operand slots, in the order of csrc/rate_lookup.cu's enums: the
#: cooling's per-cell values, the fields, the H2 shielding operands, the
#: limiter's (itmask is bool); the photo rates and unit scalars (0-d
#: views of the call's scalar block); the tables (the rates in the order
#: of chemistry_step.k_names, then k13dd and h2dust)
IN_SLOTS = (["tgas", "mmw", "tdust", "dust2gas"] + FIELD_SLOTS
            + ["l_h2shield_field", "H2_custom_shielding_factor", "edot",
               "p2d", "itmask"])
PR_SLOTS = ["k24", "k25", "k26", "k28", "k29", "k30", "k31", "crsHI",
            "crsHeI"]
US_SLOTS = ["dom", "tbase1", "c_ljeans", "xbase1"]
SCALAR_SLOTS = PR_SLOTS + US_SLOTS
TABLE_SLOTS = K_SLOTS + ["k13dd", "h2dust"]
N_IN, N_SCALAR, N_TABLE = len(IN_SLOTS), len(SCALAR_SLOTS), len(TABLE_SLOTS)
#: the cooling's values the lookup and the limiter read
COOL_SLOTS = ["tgas", "mmw", "tdust", "dust2gas", "edot", "p2d"]


class _RatesArgs(ctypes.Structure):
    """ctypes mirror of csrc/rate_lookup.cu's RatesArgs."""

    _fields_ = [
        ("n", ctypes.c_longlong),
        ("ispecies", ctypes.c_int),
        ("anydust", ctypes.c_int),
        ("three_body_rate", ctypes.c_int),
        ("h2_self_shielding", ctypes.c_int),
        ("h2_custom_shielding", ctypes.c_int),
        ("self_shielding_method", ctypes.c_int),
        ("rt", ctypes.c_int),
        ("n_bins", ctypes.c_int),
        ("n_dust_bins", ctypes.c_int),
        ("logt0", ctypes.c_double),
        ("logt9", ctypes.c_double),
        ("dlogt", ctypes.c_double),
        ("logd0", ctypes.c_double),
        ("logd9", ctypes.c_double),
        ("dlogd", ctypes.c_double),
        ("dust_t_end", ctypes.c_double),
        ("eq_step", ctypes.c_double),
        ("tiny8", ctypes.c_double),
        ("huge8", ctypes.c_double),
        ("fh", ctypes.c_double),
        ("acc", ctypes.c_double),
        ("two_kboltz", ctypes.c_double),
        ("mass_h", ctypes.c_double),
        ("table", ctypes.c_void_p * N_TABLE),
        ("scalar", ctypes.c_void_p * N_SCALAR),
        ("inp", ctypes.c_void_p * N_IN),
        ("out", ctypes.c_void_p),
    ]


library = Library(
    "rate kernel", SOURCE, NVCC_FLAGS, _RatesArgs, "grackle_rates_layout",
    {"in slots": N_IN, "scalar slots": N_SCALAR, "table slots": N_TABLE,
     "block": BLOCK},
    {"lookup": "grackle_rates_lookup"})


def _anydust(cfg) -> bool:
    """lookup_cool_rates' test: H2 formation on dust (not the cooling's,
    which dust recombination cooling also turns on)."""
    return (cfg.h2_on_dust > 0) or (cfg.dust_chemistry > 0)


def row_names(cfg) -> list[str]:
    """The rows of a launch's output, in order: the rates, the shield
    arrays, h2dust where the configuration has dust, the H2-equilibrium
    limit at chemistry 2 and 3."""
    rows = cs.k_names(cfg) + cs.SHIELD_ARRAYS
    if _anydust(cfg):
        rows.append("h2dust")
    if cfg.primordial_chemistry > 1:
        rows.append("h2_limit")
    return rows


def used_slots(cfg):
    """The names of IN_SLOTS, SCALAR_SLOTS and TABLE_SLOTS that a launch
    for ``cfg`` reads (the branches of the twin it takes); the other
    slots stay null."""
    ispecies = cfg.primordial_chemistry
    if ispecies not in (1, 2, 3):
        raise ValueError(f"rate kernel: primordial_chemistry = {ispecies} "
                         f"is not 1-3")
    h2ss = cfg.H2_self_shielding if ispecies > 1 else 0
    method = cfg.self_shielding_method
    ins = {"tgas", "density"}
    scalars = {"k24", "k25", "k26", "k28", "k29", "k30", "k31", "dom"}
    tables = set(K_SLOTS[:(8, 25, 32)[ispecies - 1]])
    if _anydust(cfg):
        ins.update(["tdust", "dust2gas"])
        tables.add("h2dust")
    if ispecies > 1:
        ins.update(["edot", "p2d", "itmask"])
        if cfg.use_radiative_transfer == 1:
            ins.add("RT_H2_dissociation_rate")
        if cfg.H2_custom_shielding > 0:
            ins.add("H2_custom_shielding_factor")
        if cfg.three_body_rate == 0:
            ins.add("HI")
            tables.add("k13dd")
    if h2ss > 0:
        ins.update(["mmw", "H2I"])
        ins.update({1: ["l_h2shield_field"],
                    2: ["H2_self_shielding_length"]}.get(h2ss, []))
        scalars.update({2: ["xbase1"], 3: ["c_ljeans"]}.get(h2ss, []))
    if method > 0:
        ins.update(["HI", "HII", "HeI", "HeII", "HeIII"])
        ins.update(["HM", "H2I", "H2II"] if ispecies > 1 else [])
        ins.update(["DI", "DII", "HDI"] if ispecies > 2 else [])
        scalars.update(["crsHI", "crsHeI", "tbase1"])
    return ins, scalars, tables


def operands(cfg, pr, us, f, cool, itmask, l_h2shield_field=None):
    """The launch's operands from the solver's arguments: (per-cell
    operands by IN_SLOTS name, 0-d scalars by SCALAR_SLOTS name), each
    only where a launch for ``cfg`` reads it."""
    ins, scalars, _ = used_slots(cfg)
    given = dict(f)
    given.update({k: getattr(cool, k) for k in COOL_SLOTS})
    given.update(itmask=itmask, l_h2shield_field=l_h2shield_field)
    values = {k: getattr(pr, k) for k in PR_SLOTS}
    values.update({k: getattr(us, k) for k in US_SLOTS})
    return ({k: given.get(k) for k in IN_SLOTS if k in ins},
            {k: values[k] for k in SCALAR_SLOTS if k in scalars})


def _check(ok, what, want, got):
    if not ok:
        name = (type(got).__name__ if not isinstance(got, torch.Tensor)
                else f"{got.dtype} {tuple(got.shape)} on {got.device}, "
                     f"contiguous={got.is_contiguous()}")
        raise ValueError(f"rate kernel {what}: want {want}, got {name}")


def _tensor(t, what, shape, device, dtype):
    _check(isinstance(t, torch.Tensor) and t.shape == shape
           and t.device == device and t.dtype == dtype
           and t.is_contiguous(), what,
           f"a contiguous {dtype} {tuple(shape)} tensor on {device}", t)
    return t


def struct(cfg, n, dtype, ptrs):
    """The argument struct of a launch for ``n`` cells of ``dtype``: the
    configuration's flags and table geometry, and ``ptrs`` ({"table",
    "scalar", "inp": the pointers by slot name, a slot not named staying
    null; "out"})."""
    ispecies = cfg.primordial_chemistry

    def logs(n_bins, t_start, t_end):
        # lookup.table_index's host values, as the twin forms them
        l0, l9 = math.log(t_start), math.log(t_end)
        return l0, l9, (l9 - l0) / (n_bins - 1)

    logt0, logt9, dlogt = logs(cfg.NumberOfTemperatureBins,
                               cfg.TemperatureStart, cfg.TemperatureEnd)
    logd0, logd9, dlogd = logs(cfg.NumberOfDustTemperatureBins,
                               cfg.DustTemperatureStart,
                               cfg.DustTemperatureEnd)
    args = _RatesArgs(
        n=n, ispecies=ispecies, anydust=int(_anydust(cfg)),
        three_body_rate=int(cfg.three_body_rate),
        h2_self_shielding=int(cfg.H2_self_shielding if ispecies > 1 else 0),
        h2_custom_shielding=int(cfg.H2_custom_shielding),
        self_shielding_method=int(cfg.self_shielding_method),
        rt=int(cfg.use_radiative_transfer == 1),
        n_bins=int(cfg.NumberOfTemperatureBins),
        n_dust_bins=int(cfg.NumberOfDustTemperatureBins),
        logt0=logt0, logt9=logt9, dlogt=dlogt,
        logd0=logd0, logd9=logd9, dlogd=dlogd,
        dust_t_end=float(cfg.DustTemperatureEnd), eq_step=0.1 * dlogt,
        tiny8=dtype_tiny8(dtype), huge8=dtype_huge8(dtype),
        fh=float(cfg.HydrogenFractionByMass),
        acc=float(cfg.subcycle_accuracy), two_kboltz=2.0 * kboltz,
        mass_h=mass_h,
        out=ptrs.get("out"))
    for field, slots in (("table", TABLE_SLOTS), ("scalar", SCALAR_SLOTS),
                         ("inp", IN_SLOTS)):
        given = ptrs.get(field, {})
        getattr(args, field)[:] = [given.get(k) for k in slots]
    return args


def prepare_launch(cfg, tables, ins, scalars):
    """Check the operands of one launch (``ins`` and ``scalars`` as
    :func:`operands` gives them) and allocate its output.  Returns
    ``(launch, out)``: ``launch()`` runs the kernel on the current
    stream, writing ``out`` (:func:`row_names` by N), and counts it
    (``library``); ``launch.bytes`` is what it must move
    (kernel_lib.Library.bind: the per-cell operands and the scalars read
    once and the rows written once, not the tables, a few hundred kB
    read from L2)."""
    tgas = ins["tgas"]
    device, dtype = tgas.device, tgas.dtype
    library.require_cuda(device)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rate kernel takes float32/float64, got {dtype}")
    want_in, want_scalar, want_table = used_slots(cfg)
    _check(set(ins) == want_in and set(scalars) == want_scalar, "operands",
           f"{sorted(want_in)} and {sorted(want_scalar)}",
           f"{sorted(ins)} and {sorted(scalars)}")
    n = tgas.shape[0]
    shape = (n,)
    ins = {k: _tensor(t, f"operand {k}", shape, device,
                      torch.bool if k == "itmask" else dtype)
           for k, t in ins.items()}
    scalars = {k: _tensor(t, f"scalar {k}", (), device, dtype)
               for k, t in scalars.items()}
    n_bins = cfg.NumberOfTemperatureBins
    table_shapes = {"k13dd": (n_bins, 14),
                    "h2dust": (n_bins, cfg.NumberOfDustTemperatureBins)}
    used_tables = {k: _tensor(getattr(tables, k), f"table {k}",
                              table_shapes.get(k, (n_bins,)), device, dtype)
                   for k in TABLE_SLOTS if k in want_table}
    out = torch.empty((len(row_names(cfg)), n), dtype=dtype, device=device)
    args = struct(cfg, n, dtype, {
        "table": {k: t.data_ptr() for k, t in used_tables.items()},
        "scalar": {k: t.data_ptr() for k, t in scalars.items()},
        "inp": {k: t.data_ptr() for k, t in ins.items()},
        "out": out.data_ptr()})
    launch = library.bind("lookup", args, dtype, device,
                          [*ins.values(), *scalars.values(), out])
    return launch, out


def twin(cfg, tables, pr, us, f, cool, itmask, l_h2shield_field=None):
    """The plain twin on any device: ``(RateState, h2_limit)`` of
    ops/chemistry_step.py ``lookup_cool_rates`` and, at chemistry 2 and
    3, ``h2_equilibrium_limit`` (None below)."""
    rs = cs.lookup_cool_rates(cfg, tables, pr, us, f, cool.tgas, cool.mmw,
                              cool.tdust, cool.dust2gas, l_h2shield_field)
    h2_limit = None
    if cfg.primordial_chemistry > 1:
        h2_limit = cs.h2_equilibrium_limit(cfg, tables, rs, cool, f, us,
                                           itmask)
    return rs, h2_limit


def rows_of(cfg, rs, h2_limit):
    """The values of :func:`row_names`, in order, from a RateState and
    the limit."""
    values = dict(rs.k, **{k: rs.shields[k] for k in cs.SHIELD_ARRAYS},
                  h2dust=rs.h2dust, h2_limit=h2_limit)
    return [values[k] for k in row_names(cfg)]


def twin_rows(cfg, tables, *flat):
    """:func:`twin` on a launch's operands (IN_SLOTS, then SCALAR_SLOTS,
    None where unused): its rows, in the order the kernel writes them,
    what a launch's backward differentiates."""
    ins = dict(zip(IN_SLOTS, flat[:N_IN]))
    scalars = dict(zip(SCALAR_SLOTS, flat[N_IN:]))
    f = {k: ins[k] for k in FIELD_SLOTS + ["H2_custom_shielding_factor"]
         if ins[k] is not None}
    pr = types.SimpleNamespace(k27=None, **{k: scalars[k] for k in PR_SLOTS})
    us = types.SimpleNamespace(**{k: scalars[k] for k in US_SLOTS})
    cool = types.SimpleNamespace(**{k: ins[k] for k in COOL_SLOTS})
    rs, h2_limit = twin(cfg, tables, pr, us, f, cool, ins["itmask"],
                        ins["l_h2shield_field"])
    return tuple(rows_of(cfg, rs, h2_limit))


def _flat(ins, scalars):
    return ([ins.get(k) for k in IN_SLOTS]
            + [scalars.get(k) for k in SCALAR_SLOTS])


class _RateLookup(torch.autograd.Function):
    """The launch; its backward is the twin's."""

    @staticmethod
    def forward(ctx, cfg, tables, *flat):
        save_twin_args(ctx, (cfg, tables), flat)
        ins = {k: t for k, t in zip(IN_SLOTS, flat[:N_IN]) if t is not None}
        scalars = {k: t for k, t in zip(SCALAR_SLOTS, flat[N_IN:])
                   if t is not None}
        launch, out = prepare_launch(cfg, tables, ins, scalars)
        launch()
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        # the twin's product over the rows that carry a gradient: a row
        # the caller left out (the limit's, say) adds nothing, where its
        # zero times a derivative of inf would add NaN
        rows = grad.unbind(0)
        keep = [bool(g.any()) for g in rows]

        def kept_rows(*args):
            return tuple(r for r, k in zip(twin_rows(*args), keep) if k)

        return (None, None, *twin_vjp(
            ctx, kept_rows, tuple(g for g, k in zip(rows, keep) if k)))


def rate_lookup_cuda(cfg, tables, pr, us, f, cool, itmask,
                     l_h2shield_field=None):
    """:func:`twin` as one CUDA launch; same arguments, the same
    ``(RateState, h2_limit)`` (its arrays rows of the launch's output),
    and the twin's gradient."""
    ins, scalars = operands(cfg, pr, us, f, cool, itmask, l_h2shield_field)
    out = _RateLookup.apply(cfg, tables, *_flat(ins, scalars))
    rows = dict(zip(row_names(cfg), out.unbind(0)))
    shields = {k: rows[k] for k in cs.SHIELD_ARRAYS}
    shields["k27"] = pr.k27
    rs = cs.RateState(k={k: rows[k] for k in cs.k_names(cfg)}, k13dd=None,
                      h2dust=rows.get("h2dust"), shields=shields, ti=None)
    return rs, rows.get("h2_limit")


_runs_kernel = functools.partial(runs_kernel, what="rate lookup")


def rate_lookup(cfg, tables, pr, us, f, cool, itmask, l_h2shield_field=None):
    """The subcycle's rates, shields, h2dust and H2-equilibrium limit:
    the CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    Returns ``(RateState, h2_limit)``, ``h2_limit`` None at chemistry
    1."""
    args = (cfg, tables, pr, us, f, cool, itmask, l_h2shield_field)
    if _runs_kernel(cool.tgas.device):
        return rate_lookup_cuda(*args)
    return twin(*args)
