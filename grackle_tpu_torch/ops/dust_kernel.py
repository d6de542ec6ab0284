"""The equilibrium dust temperature as one hand-written CUDA launch, and
its routing.

:func:`dust_temperature` is what the cooling code and the derived dust
temperature call.  On CPU tensors it runs the plain twin
(ops/dust_temp.py ``calc_tdust_1d``: Newton, then bisection, as masked
sweeps of every cell); on CUDA tensors it launches csrc/dust_temp.cu,
one launch a call, in which each thread solves its own cell and stops at
its own convergence, or raises.  There is no fallback from the card to
the twin.  The kernel solves every cell: it takes no active-cell mask,
and the wrapper refuses one (the callers pass none).

The library is built at first use with ``nvcc`` for sm_90a from the
source in this package, into ``grackle_tpu_torch/_build/``, loaded with
ctypes and launched on PyTorch's current stream, so a CUDA-graph capture
records it (ops/kernel_lib.Library, with its POW_FLAGS: under nvcc's
default FMA contraction CUDA's pow rounds as PyTorch's).  The kernel
reads the CMB temperature through a pointer to its 0-d tensor, so a
graph replays with a new ``a_value``; the ISRF heating coefficient is
the rate tables' host float.  Each launch is an autograd function whose
backward recomputes the twin and returns its vector-Jacobian product.

``library`` counts the launches: those issued on the host, and where its
``count_replays`` armed the device before a capture, those that graphs
replayed, counted on the card (ops/kernel_lib.Library).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
from torch.autograd.function import once_differentiable

from .dust_temp import calc_tdust_1d
from .kernel_lib import (PKG_DIR, POW_FLAGS, Library, runs_kernel,
                         save_twin_args, twin_vjp)

SOURCE = os.path.join(PKG_DIR, "csrc", "dust_temp.cu")
#: the kernel calls CUDA's pow
NVCC_FLAGS = POW_FLAGS
#: threads a CTA, one cell each: csrc/dust_temp.cu's BLOCK
BLOCK = 128

#: operand slots, in the order of csrc/dust_temp.cu's enum
IN_SLOTS = ["tgas", "nh", "gasgr", "isrf", "tdust_init"]
N_IN = len(IN_SLOTS)


class _DustArgs(ctypes.Structure):
    """ctypes mirror of csrc/dust_temp.cu's DustArgs."""

    _fields_ = [
        ("n", ctypes.c_longlong),
        ("gamma_isrf", ctypes.c_double),
        ("trad", ctypes.c_void_p),
        ("inp", ctypes.c_void_p * N_IN),
        ("out", ctypes.c_void_p),
    ]


library = Library(
    "dust kernel", SOURCE, NVCC_FLAGS, _DustArgs, "grackle_dust_layout",
    {"in slots": N_IN, "block": BLOCK},
    {"temperature": "grackle_dust_temperature"})


def _operand(t, name, shape, device, dtype):
    """A per-cell operand as a contiguous [N] tensor, checked against the
    launch's shape, device and dtype."""
    _check(isinstance(t, torch.Tensor) and t.shape == shape
           and t.device == device and t.dtype == dtype,
           f"operand {name}", f"{dtype} {tuple(shape)} on {device}", t)
    return t.reshape(-1).contiguous()


def _check(ok, what, want, got):
    if not ok:
        name = (type(got).__name__ if not isinstance(got, torch.Tensor)
                else f"{got.dtype} {tuple(got.shape)} on {got.device}")
        raise ValueError(f"dust kernel {what}: want {want}, got {name}")


def prepare_launch(tgas, nh, gasgr, gamma_isrf_coef, isrf, itmask, trad,
                   tdust_init=None):
    """Check the operands of one launch and allocate its output.  Returns
    ``(launch, tdust)``: ``launch()`` runs the kernel on the current
    stream, writing tdust, and counts it (``library``); ``launch.bytes``
    is what it must move (kernel_lib.Library.bind)."""
    device, dtype, shape = tgas.device, tgas.dtype, tgas.shape
    _check(itmask is None, "itmask", "None (the kernel solves every cell)",
           itmask)
    library.require_cuda(device)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dust kernel takes float32/float64, got {dtype}")
    ins = {name: _operand(t, name, shape, device, dtype)
           for name, t in (("tgas", tgas), ("nh", nh), ("gasgr", gasgr),
                           ("isrf", isrf), ("tdust_init", tdust_init))
           if t is not None}
    _check(isinstance(trad, torch.Tensor) and trad.shape == ()
           and trad.device == device and trad.dtype == dtype, "trad",
           f"a 0-d {dtype} tensor on {device}", trad)
    _check(not isinstance(gamma_isrf_coef, torch.Tensor), "gamma_isrf",
           "a host float (as the rate tables hold it)", gamma_isrf_coef)
    out = torch.empty(shape, dtype=dtype, device=device)
    args = _DustArgs(n=ins["tgas"].shape[0],
                     gamma_isrf=float(gamma_isrf_coef),
                     trad=trad.data_ptr(), out=out.data_ptr())
    args.inp[:] = [ins[k].data_ptr() if k in ins else None
                   for k in IN_SLOTS]
    launch = library.bind("temperature", args, dtype, device,
                          [*ins.values(), trad, out])
    return launch, out


class _DustTemperature(torch.autograd.Function):
    """The launch; its backward is the twin's."""

    @staticmethod
    def forward(ctx, *args):
        save_twin_args(ctx, (), args)
        launch, out = prepare_launch(*args)
        launch()
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return tuple(twin_vjp(ctx, calc_tdust_1d, (grad,)))


def dust_temperature_cuda(tgas, nh, gasgr, gamma_isrf_coef, isrf, itmask,
                          trad, tdust_init=None):
    """ops/dust_temp.py ``calc_tdust_1d`` as one CUDA launch; same
    arguments (``itmask`` None), same result, and the twin's gradient."""
    return _DustTemperature.apply(tgas, nh, gasgr, gamma_isrf_coef, isrf,
                                  itmask, trad, tdust_init)


_runs_kernel = functools.partial(runs_kernel,
                                 what="dust temperature solve")


def dust_temperature(tgas, nh, gasgr, gamma_isrf_coef, isrf, itmask, trad,
                     tdust_init=None):
    """The equilibrium dust temperature of every cell: the CUDA kernel
    for CUDA tensors, the plain twin (ops/dust_temp.py) for CPU
    tensors.  Arguments as ``calc_tdust_1d``'s; on CUDA tensors
    ``itmask`` is None."""
    args = (tgas, nh, gasgr, gamma_isrf_coef, isrf, itmask, trad,
            tdust_init)
    if _runs_kernel(tgas.device):
        return dust_temperature_cuda(*args)
    return calc_tdust_1d(*args)
