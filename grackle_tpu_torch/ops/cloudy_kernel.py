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
source in this package, into ``grackle_tpu_torch/_build/`` (the network
kernel's build, ops/network_kernel.py, with NVCC_FLAGS), loaded with
ctypes and launched on PyTorch's current stream, so a CUDA-graph capture
records it.  The kernels read the call's unit scalars (``dom``, ``zr``,
``utem``, ``comp2``) through pointers into its scalar block, so a graph
replays with a new ``a_value``.  Each launch is an autograd function
whose backward recomputes the twin and returns its vector-Jacobian
product, so a differentiable call runs the kernel forward too.

``launches`` counts the launches issued on the host, eager or recorded
into a capture, per entry (``"fixed_point"``, ``"cooling"``);
``recorded`` those of them recorded into a capture.  Where
:func:`count_replays` armed the device before a capture, the graph counts
its launches on the device at every replay, as the network kernel's do
(ops/network_kernel.count_replays): :func:`executed_launches` is then the
launches that ran on the card.
"""

from __future__ import annotations

import collections
import ctypes
import math
import os
import threading

import torch
from torch.autograd.function import once_differentiable

from . import cloudy_cool as _plain_cool
from . import network_kernel
from . import tabulated_temp as _plain_temp
from .network_kernel import _PKG_DIR, ReplayCounter, compile_library

SOURCE = os.path.join(_PKG_DIR, "csrc", "cloudy_interp.cu")
#: the network kernel's flags (ops/network_kernel.py) but for FMA
#: contraction, left at nvcc's default as in PyTorch's own build: CUDA's
#: pow rounds differently under -fmad=false (an ulp in 12 of phase 2c's
#: 504 card checks, PERF.md).  The kernels' own arithmetic is explicit
#: round-to-nearest intrinsics, which no flag contracts
NVCC_FLAGS = ["-fmad=true" if f == "-fmad=false" else f
              for f in network_kernel.NVCC_FLAGS]
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


#: launches issued on the host since the process started (or
#: zero_launch_counts), eager or recorded into a capture, per entry
launches = collections.Counter()
#: of ``launches``, those recorded into a capture, per entry
recorded = collections.Counter()
_replays = ReplayCounter()

_lib = None
_lib_lock = threading.Lock()
#: compiler output of this process's build ("" when the library existed)
build_log = ""


def build() -> str:
    """Compile csrc/cloudy_interp.cu with nvcc (if not yet built) and
    return the library path.  Raises if nvcc fails."""
    global build_log
    out, log = compile_library(SOURCE, NVCC_FLAGS)
    if log:
        build_log = log
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            cint_p = ctypes.POINTER(ctypes.c_int)
            lib.grackle_cloudy_layout.argtypes = [cint_p] * 5
            lib.grackle_cloudy_layout.restype = ctypes.c_int
            for fn in (lib.grackle_cloudy_fixed_point,
                       lib.grackle_cloudy_cooling):
                fn.argtypes = [ctypes.POINTER(_CloudyArgs), ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            vals = [ctypes.c_int() for _ in range(5)]
            size = lib.grackle_cloudy_layout(*map(ctypes.byref, vals))
            got = tuple(v.value for v in vals) + (size,)
            want = (N_IN, N_OUT, N_SCALAR, N_DATA, BLOCK,
                    ctypes.sizeof(_CloudyArgs))
            if got != want:
                raise RuntimeError(
                    f"Cloudy kernel layout mismatch: the library has "
                    f"(in, out, scalar, data slots, block, struct bytes) "
                    f"{got}, the wrapper {want}")
            _lib = lib
    return _lib


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


def _launch(entry, args, dtype, device):
    """Launch ``entry`` on the current stream of ``device`` and count it:
    on the host, and where the launch is recorded into a capture on an
    armed device, on the device at every replay."""
    lib = load()
    fn = (lib.grackle_cloudy_fixed_point if entry == "fixed_point"
          else lib.grackle_cloudy_cooling)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.byref(args), int(dtype == torch.float64),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"Cloudy kernel {entry} launch failed: CUDA "
                           f"error {err}")
    launches[entry] += 1
    if torch.cuda.is_current_stream_capturing():
        recorded[entry] += 1
        _replays.record(device)


def count_replays(device):
    """Count on ``device`` the Cloudy launches that CUDA graphs captured
    from now on make when they replay; a no-op off the card.  Not inside
    a capture."""
    _replays.arm(device)


def replayed_launches() -> int:
    """The Cloudy launches that graphs replayed since the counts were
    armed or zeroed, summed over the devices (reads them on the host)."""
    return _replays.total()


def executed_launches() -> int:
    """The Cloudy launches that ran on the card since the counts were
    zeroed: the eager ones and those that armed graphs replayed."""
    return (sum(launches.values()) - sum(recorded.values())
            + replayed_launches())


def zero_launch_counts():
    """Set the host counts and every device's replay count to 0."""
    launches.clear()
    recorded.clear()
    _replays.zero()


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
        _save(ctx, cloudy, args)
        return _fixed_point_launch(cloudy, *args)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None, *_twin_vjp(ctx, _plain_temp.tabulated_temperature,
                                 grads))


class _Cooling(torch.autograd.Function):
    """The cooling launch; its backward is the twin's."""

    @staticmethod
    def forward(ctx, cloudy, *args):
        _save(ctx, cloudy, args)
        return _cooling_launch(cloudy, *args)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None, *_twin_vjp(ctx, _plain_cool.cloudy_cooling, grads))


def _save(ctx, cloudy, args):
    """Keep a launch's table, tensors and other arguments for its
    backward."""
    is_tensor = [isinstance(a, torch.Tensor) for a in args]
    ctx.cloudy, ctx.is_tensor = cloudy, is_tensor
    ctx.consts = [None if t else a for a, t in zip(args, is_tensor)]
    ctx.save_for_backward(*(a for a, t in zip(args, is_tensor) if t))


def _twin_vjp(ctx, twin, grads):
    """The gradient of every argument after the table (None where it
    needs none): the vector-Jacobian product of ``twin``, recomputed on
    the forward's inputs."""
    saved = iter(ctx.saved_tensors)
    needs = ctx.needs_input_grad[1:]
    args = [next(saved).detach().requires_grad_(need) if t else a
            for a, t, need in zip(ctx.consts, ctx.is_tensor, needs)]
    with torch.enable_grad():
        outs = twin(ctx.cloudy, *args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
    wrt = [a for a, need in zip(args, needs) if need]
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   wrt, [g for _, g in pairs],
                                   allow_unused=True)
               if pairs else [None] * len(wrt))
    return [next(got) if need else None for need in needs]


def _fixed_point_launch(cloudy, d, metal, e, rhoH, dom, zr, temstart,
                        gamma, utem, imetal):
    device = e.device
    shape, (d_f, metal_f, e_f, rhoH_f), dtype = _operands(
        [d if imetal else None, metal if imetal else None, e, rhoH], device)
    rank, dims, pars, data = _grid_fields(cloudy, {"mmw": cloudy.mmw},
                                          device, dtype)
    scalars = {"dom": _scalar(dom, "dom", device, dtype),
               "zr": _scalar(zr, "zr", device, dtype),
               "utem": _scalar(utem, "utem", device, dtype)}
    tgas, mmw = (torch.empty(shape, dtype=dtype, device=device)
                 for _ in range(2))
    args = _args(e_f.shape[0], rank, dims, pars, data, scalars,
                 {"density": d_f, "metal": metal_f, "energy": e_f,
                  "rhoH": rhoH_f}, {"tgas": tgas, "mmw": mmw})
    args.ti_max = _plain_temp.TI_MAX
    args.imetal = int(bool(imetal))
    args.gamma_m1 = gamma - 1.0
    args.temstart = float(temstart)
    _launch("fixed_point", args, dtype, device)
    return tgas, mmw


def _cooling_launch(cloudy, logtem, rhoH, metallicity, dom, zr, comp2,
                    icmbTfloor, iClHeat, iZscale):
    device = logtem.device
    heat = iClHeat == 1 and cloudy.heating is not None
    zscale = iZscale == 1
    shape, (logtem_f, rhoH_f, z_f), dtype = _operands(
        [logtem, rhoH, metallicity if zscale else None], device)
    tables = {"cooling": cloudy.cooling}
    if heat:
        tables["heating"] = cloudy.heating
    rank, dims, pars, data = _grid_fields(cloudy, tables, device, dtype)
    scalars = {"dom": _scalar(dom, "dom", device, dtype),
               "zr": _scalar(zr, "zr", device, dtype),
               "comp2": _scalar(comp2, "comp2", device, dtype)}
    edot = torch.empty(shape, dtype=dtype, device=device)
    args = _args(logtem_f.shape[0], rank, dims, pars, data, scalars,
                 {"logtem": logtem_f, "rhoH": rhoH_f, "metallicity": z_f},
                 {"edot": edot})
    args.icmbTfloor = int(icmbTfloor == 1)
    args.iClHeat = int(heat)
    args.iZscale = int(zscale)
    _launch("cooling", args, dtype, device)
    return edot


def _args(n, rank, dims, pars, data, scalars, ins, outs):
    args = _CloudyArgs(n=n, rank=rank, inv_log10=1.0 / math.log(10.0))
    args.dim[:len(dims)] = dims
    args.par[:rank] = pars
    args.data[:] = data
    args.scalar[:] = [scalars[k].data_ptr() if k in scalars else None
                      for k in SCALAR_SLOTS]
    args.inp[:] = [ins[k].data_ptr() if ins.get(k) is not None else None
                   for k in IN_SLOTS]
    args.out[:] = [outs[k].data_ptr() if k in outs else None
                   for k in OUT_SLOTS]
    return args


def _runs_kernel(device) -> bool:
    """Whether a call on ``device`` launches the kernel: on CUDA
    tensors; CPU tensors run the twin, other devices raise."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no Cloudy lookup for device {device}")
    return True


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
