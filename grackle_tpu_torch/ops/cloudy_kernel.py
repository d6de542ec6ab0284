"""The Cloudy table lookups of the subcycle body as hand-written CUDA
launches, and their routing.

:func:`tabulated_temperature` and :func:`cloudy_cooling` are what the
cooling code calls.  On CPU tensors they run the plain twins
(ops/tabulated_temp.py ``tabulated_temperature``, ops/cloudy_cool.py
``cloudy_cooling``: torch gathers and lerps, ops/interp.py); on CUDA
tensors they launch csrc/cloudy_interp.cu, one launch a call, or raise.
There is no fallback from the card to the twins.  Only new-style tables
(rank 1 to 3) come here: old-style ones keep ops/cloudy_cool.py
``cloudy_cooling_old_tables``.

The library is built at first use with ``nvcc`` for sm_90a from the
source in this package, into ``grackle_tpu_torch/_build/``, loaded with
ctypes and launched on PyTorch's current stream, so a CUDA-graph capture
records it (ops/kernel_lib.Library, with its POW_FLAGS).  The kernels
read the call's unit scalars (``dom``, ``zr``, ``utem``, ``comp2``)
through pointers into its scalar block, so a graph replays with a new
``a_value``.  Each launch is an autograd function
whose backward recomputes the twin and returns its vector-Jacobian
product, so a differentiable call runs the kernel forward too.

``library`` counts the launches per entry (``"fixed_point"``,
``"cooling"``): those issued on the host, and where its
``count_replays`` armed the device before a capture, those that graphs
replayed, counted on the card (ops/kernel_lib.Library).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch
from torch.autograd.function import once_differentiable

from . import cloudy_cool as _plain_cool
from . import tabulated_temp as _plain_temp
from .kernel_lib import (PKG_DIR, POW_FLAGS, Library, runs_kernel,
                         save_twin_args, twin_vjp)

SOURCE = os.path.join(PKG_DIR, "csrc", "cloudy_interp.cu")
#: the kernels call CUDA's pow
NVCC_FLAGS = POW_FLAGS
#: threads a CTA, one cell each: csrc/cloudy_interp.cu's BLOCK
BLOCK = 128

#: operand slots, in the order of csrc/cloudy_interp.cu's enums
IN_SLOTS = ["density", "metal", "energy", "rhoH", "logtem", "metallicity"]
OUT_SLOTS = ["tgas", "mmw", "edot"]
SCALAR_SLOTS = ["dom", "zr", "utem", "comp2"]
DATA_SLOTS = ["mmw", "cooling", "heating"]
N_IN, N_OUT = len(IN_SLOTS), len(OUT_SLOTS)
N_SCALAR, N_DATA = len(SCALAR_SLOTS), len(DATA_SLOTS)


class _CloudyArgs(ctypes.Structure):
    """ctypes mirror of csrc/cloudy_interp.cu's CloudyArgs."""

    _fields_ = [
        ("n", ctypes.c_longlong),
        ("rank", ctypes.c_int),
        ("dim", ctypes.c_int * 3),
        ("ti_max", ctypes.c_int),
        ("imetal", ctypes.c_int),
        ("icmbTfloor", ctypes.c_int),
        ("iClHeat", ctypes.c_int),
        ("iZscale", ctypes.c_int),
        ("gamma_m1", ctypes.c_double),
        ("temstart", ctypes.c_double),
        ("inv_log10", ctypes.c_double),
        ("par", ctypes.c_void_p * 3),
        ("data", ctypes.c_void_p * N_DATA),
        ("scalar", ctypes.c_void_p * N_SCALAR),
        ("inp", ctypes.c_void_p * N_IN),
        ("out", ctypes.c_void_p * N_OUT),
    ]


library = Library(
    "Cloudy kernel", SOURCE, NVCC_FLAGS, _CloudyArgs, "grackle_cloudy_layout",
    {"in slots": N_IN, "out slots": N_OUT, "scalar slots": N_SCALAR,
     "data slots": N_DATA, "block": BLOCK},
    {"fixed_point": "grackle_cloudy_fixed_point",
     "cooling": "grackle_cloudy_cooling"})


def _grid_fields(cloudy, data, device, dtype):
    """(rank, dims, axis pointers, data pointers) of a new-style table,
    checked against the launch's device and dtype."""
    rank = cloudy.grid_rank
    if rank not in (1, 2, 3):
        raise ValueError(f"Cloudy kernel: a new-style table has rank 1-3, "
                         f"got {rank}")
    dims = tuple(int(x) for x in cloudy.grid_dimension)
    pars = [cloudy.par1, cloudy.par2, cloudy.par3][:rank]
    for q, par in enumerate(pars):
        _check_table(par, f"par{q + 1}", (dims[q],), device, dtype)
    ptrs = [None] * N_DATA
    for name, t in data.items():
        _check_table(t, name, dims, device, dtype)
        ptrs[DATA_SLOTS.index(name)] = t.data_ptr()
    return rank, dims, [p.data_ptr() for p in pars], ptrs


def _check_table(t, name, shape, device, dtype):
    if (not isinstance(t, torch.Tensor) or t.device != device
            or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        got = (type(t).__name__ if not isinstance(t, torch.Tensor)
               else f"{t.dtype} {tuple(t.shape)} on {t.device}, "
                    f"contiguous={t.is_contiguous()}")
        raise ValueError(f"Cloudy kernel table {name}: want a contiguous "
                         f"{dtype} {shape} tensor on {device}, got {got}")


def _scalar(v, name, device, dtype):
    """A unit scalar, an element of the call's scalar block: checked to
    be a 0-d tensor of the launch's dtype on its device."""
    if (not isinstance(v, torch.Tensor) or v.shape != ()
            or v.device != device or v.dtype != dtype):
        got = (type(v).__name__ if not isinstance(v, torch.Tensor)
               else f"{v.dtype} {tuple(v.shape)} on {v.device}")
        raise ValueError(f"Cloudy kernel scalar {name}: want a 0-d {dtype} "
                         f"tensor on {device}, got {got}")
    return v


def _operands(tensors, device):
    """The per-cell operands (None where unused), of one shape, dtype and
    device, each as a contiguous [N] tensor: (shape, flat tensors,
    dtype)."""
    used = [t for t in tensors if t is not None]
    shape, dtype = used[0].shape, used[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Cloudy kernel takes float32/float64, got {dtype}")
    for t in used:
        if t.device != device or t.dtype != dtype or t.shape != shape:
            raise ValueError(f"Cloudy kernel operand: want {dtype} "
                             f"{tuple(shape)} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return shape, [None if t is None else t.reshape(-1).contiguous()
                   for t in tensors], dtype


def fixed_point_cuda(cloudy, d, metal, e, rhoH, dom, zr, temstart, gamma,
                     utem, imetal: bool):
    """ops/tabulated_temp.py ``tabulated_temperature`` as one CUDA launch;
    same arguments, same (tgas, mmw), and the twin's gradient."""
    return _FixedPoint.apply(cloudy, d, metal, e, rhoH, dom, zr, temstart,
                             gamma, utem, imetal)


def cooling_cuda(cloudy, logtem, rhoH, metallicity, dom, zr, comp2,
                 icmbTfloor: int, iClHeat: int, iZscale: int):
    """ops/cloudy_cool.py ``cloudy_cooling`` as one CUDA launch; same
    arguments, same edot contribution, and the twin's gradient."""
    return _Cooling.apply(cloudy, logtem, rhoH, metallicity, dom, zr, comp2,
                          icmbTfloor, iClHeat, iZscale)


class _FixedPoint(torch.autograd.Function):
    """The fixed-point launch; its backward is the twin's."""

    @staticmethod
    def forward(ctx, cloudy, *args):
        save_twin_args(ctx, (cloudy,), args)
        launch, out = prepare_fixed_point(cloudy, *args)
        launch()
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None, *twin_vjp(ctx, _plain_temp.tabulated_temperature,
                                grads))


class _Cooling(torch.autograd.Function):
    """The cooling launch; its backward is the twin's."""

    @staticmethod
    def forward(ctx, cloudy, *args):
        save_twin_args(ctx, (cloudy,), args)
        launch, out = prepare_cooling(cloudy, *args)
        launch()
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None, *twin_vjp(ctx, _plain_cool.cloudy_cooling, grads))


def prepare_fixed_point(cloudy, d, metal, e, rhoH, dom, zr, temstart,
                        gamma, utem, imetal):
    """Check the operands of one fixed-point launch and allocate its
    outputs.  Returns ``(launch, (tgas, mmw))``: ``launch()`` runs the
    kernel on the current stream, writing tgas and mmw, and counts it
    (``library``); ``launch.bytes`` is what it must move
    (kernel_lib.Library.bind: the per-cell operands and the unit
    scalars, not the tables, a few hundred kB read from L2)."""
    device = e.device
    library.require_cuda(device)
    shape, (d_f, metal_f, e_f, rhoH_f), dtype = _operands(
        [d if imetal else None, metal if imetal else None, e, rhoH], device)
    table = _grid_fields(cloudy, {"mmw": cloudy.mmw}, device, dtype)
    scalars = {"dom": _scalar(dom, "dom", device, dtype),
               "zr": _scalar(zr, "zr", device, dtype),
               "utem": _scalar(utem, "utem", device, dtype)}
    tgas, mmw = (torch.empty(shape, dtype=dtype, device=device)
                 for _ in range(2))
    launch = _bind("fixed_point", device, dtype, table, scalars,
                   {"density": d_f, "metal": metal_f, "energy": e_f,
                    "rhoH": rhoH_f}, {"tgas": tgas, "mmw": mmw},
                   ti_max=_plain_temp.TI_MAX, imetal=int(bool(imetal)),
                   gamma_m1=gamma - 1.0, temstart=float(temstart))
    return launch, (tgas, mmw)


def prepare_cooling(cloudy, logtem, rhoH, metallicity, dom, zr, comp2,
                    icmbTfloor, iClHeat, iZscale):
    """Check the operands of one cooling launch and allocate its output.
    Returns ``(launch, edot)``, ``launch`` as
    :func:`prepare_fixed_point`'s."""
    device = logtem.device
    library.require_cuda(device)
    heat = iClHeat == 1 and cloudy.heating is not None
    zscale = iZscale == 1
    shape, (logtem_f, rhoH_f, z_f), dtype = _operands(
        [logtem, rhoH, metallicity if zscale else None], device)
    tables = {"cooling": cloudy.cooling}
    if heat:
        tables["heating"] = cloudy.heating
    table = _grid_fields(cloudy, tables, device, dtype)
    scalars = {"dom": _scalar(dom, "dom", device, dtype),
               "zr": _scalar(zr, "zr", device, dtype),
               "comp2": _scalar(comp2, "comp2", device, dtype)}
    edot = torch.empty(shape, dtype=dtype, device=device)
    launch = _bind("cooling", device, dtype, table, scalars,
                   {"logtem": logtem_f, "rhoH": rhoH_f, "metallicity": z_f},
                   {"edot": edot}, icmbTfloor=int(icmbTfloor == 1),
                   iClHeat=int(heat), iZscale=int(zscale))
    return launch, edot


def _bind(entry, device, dtype, table, scalars, ins, outs, **flags):
    """The launch of ``entry``: its argument struct from the table's grid
    fields, the unit scalars, the per-cell operands (None where unused),
    the outputs and ``flags``, the struct's other fields."""
    rank, dims, pars, data = table
    ins = {k: t for k, t in ins.items() if t is not None}
    args = _CloudyArgs(n=next(iter(ins.values())).shape[0], rank=rank,
                       inv_log10=1.0 / math.log(10.0), **flags)
    args.dim[:len(dims)] = dims
    args.par[:rank] = pars
    args.data[:] = data
    args.scalar[:] = [scalars[k].data_ptr() if k in scalars else None
                      for k in SCALAR_SLOTS]
    args.inp[:] = [ins[k].data_ptr() if k in ins else None
                   for k in IN_SLOTS]
    args.out[:] = [outs[k].data_ptr() if k in outs else None
                   for k in OUT_SLOTS]
    return library.bind(entry, args, dtype, device,
                        [*ins.values(), *outs.values(), *scalars.values()])


_runs_kernel = functools.partial(runs_kernel, what="Cloudy lookup")


def tabulated_temperature(cloudy, d, metal, e, rhoH, dom, zr, temstart,
                          gamma, utem, imetal: bool):
    """The tabulated (T, mu) of every cell: the CUDA kernel for CUDA
    tensors, the plain twin (ops/tabulated_temp.py) for CPU tensors."""
    args = (cloudy, d, metal, e, rhoH, dom, zr, temstart, gamma, utem,
            imetal)
    if _runs_kernel(e.device):
        return fixed_point_cuda(*args)
    return _plain_temp.tabulated_temperature(*args)


def cloudy_cooling(cloudy, logtem, rhoH, metallicity, dom, zr, comp2,
                   icmbTfloor: int, iClHeat: int, iZscale: int):
    """The new-style Cloudy edot contribution: the CUDA kernel for CUDA
    tensors, the plain twin (ops/cloudy_cool.py) for CPU tensors."""
    args = (cloudy, logtem, rhoH, metallicity, dom, zr, comp2, icmbTfloor,
            iClHeat, iZscale)
    if _runs_kernel(logtem.device):
        return cooling_cuda(*args)
    return _plain_cool.cloudy_cooling(*args)
