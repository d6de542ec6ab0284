"""The network region as one hand-written CUDA launch, and its routing.

:func:`network_update` is what the solver calls every subcycle.  On CPU
tensors it runs the plain twin (ops/network.py); on CUDA tensors it
launches csrc/network_update.cu through :func:`network_update_cuda`, or
raises.  There is no fallback from the card to the twin.

The kernel replaces grackle_tpu/ops/network_kernel.py
``network_update_pallas`` (the JAX package's one ``pl.pallas_call``) and
takes every configuration that kernel takes: primordial_chemistry 0-3,
``compensated_sums`` and the radiative-transfer rate fields.  It is
built at first use with ``nvcc`` for sm_90a from the source in this
package, into ``grackle_tpu_torch/_build/``, loaded with ctypes and
launched on PyTorch's current stream (ops/kernel_lib.Library, with its
EXACT_FLAGS).  It is a persistent grid of CTAs, one cell a thread; this
module picks the operands a configuration reads (:func:`input_slots`)
and sizes the grid.  See the source's header for what bounds the kernel
and why it is shaped as it is.

``library`` counts the launches: those issued on the host, and where its
``count_replays`` armed the device before a capture, those that graphs
replayed, counted on the card (ops/kernel_lib.Library).
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import torch

from . import network as _plain
from .common import as_dt, dtype_huge8, dtype_tiny8, dtype_tolerance
from .kernel_lib import EXACT_FLAGS, PKG_DIR, Library, runs_kernel

SOURCE = os.path.join(PKG_DIR, "csrc", "network_update.cu")
#: each operation rounds as the plain twin's separate PyTorch op does
NVCC_FLAGS = EXACT_FLAGS

#: cells per tile, one thread each (a CTA of four warps):
#: csrc/network_update.cu's TILE
TILE = 128

#: operand slots, in the order of csrc/network_update.cu's enum In
SPECIES_SLOTS = ["de", "HI", "HII", "HeI", "HeII", "HeIII", "HM", "H2I",
                 "H2II", "DI", "DII", "HDI"]
RT_SLOTS = ["RT_HI_ionization_rate", "RT_HeI_ionization_rate",
            "RT_HeII_ionization_rate"]
FIELD_SLOTS = ["density", "energy"] + SPECIES_SLOTS + RT_SLOTS
K_SLOTS = ["k1", "k2", "k3", "k4", "k5", "k6", "k57", "k58",
           "k7", "k8", "k9", "k10", "k11", "k12", "k13", "k14", "k15",
           "k16", "k17", "k18", "k19", "k22", "n_cr_n", "n_cr_d1",
           "n_cr_d2", "k50", "k51", "k52", "k53", "k54", "k55", "k56"]
SHIELD_SLOTS = ["k24", "k25", "k26", "k28", "k29", "k30", "k31"]
COOL_SLOTS = ["edot", "tgas", "p2d", "rhoH", "tgasold", "tdust"]
CARRY_SLOTS = ["ttot", "tgasold", "tdust", "dedot_prev", "HIdot_prev",
               "dtit_prev", "itmask", "cell_it", "capped", "energy_lo",
               "ttot_lo"]
#: every input slot in order, with h2dust after the shields and the
#: H2-equilibrium limit last
IN_SLOTS = (FIELD_SLOTS + K_SLOTS + SHIELD_SLOTS + ["h2dust"] + COOL_SLOTS
            + CARRY_SLOTS + ["h2_limit"])
N_IN = len(IN_SLOTS)
#: first slot of each group of IN_SLOTS
_K0 = len(FIELD_SLOTS)
_SHIELD0 = _K0 + len(K_SLOTS)
_H2DUST = _SHIELD0 + len(SHIELD_SLOTS)
_COOL0 = _H2DUST + 1
_CARRY0 = _COOL0 + len(COOL_SLOTS)
_H2_LIMIT = _CARRY0 + len(CARRY_SLOTS)
#: output slots, in the order of csrc/network_update.cu's enum Out
OUT_FIELD_SLOTS = ["energy"] + SPECIES_SLOTS
OUT_CARRY_SLOTS = CARRY_SLOTS
N_OUT = len(OUT_FIELD_SLOTS) + len(OUT_CARRY_SLOTS)
#: device scalars, in the order of csrc/network_update.cu's enum Scalar:
#: elements of the call's scalar block (ops/common.scalar_block), read
#: through a pointer each
SCALAR_SLOTS = ["dom", "chunit", "k27"]
N_SCALAR = len(SCALAR_SLOTS)
#: carry slots that only compensated_sums = 1 uses
COMPENSATED_SLOTS = ["energy_lo", "ttot_lo"]
#: the carry's masks and counter; every other operand is the float type
FLAG_DTYPES = {"itmask": torch.bool, "capped": torch.bool,
               "cell_it": torch.int32}


class _NetworkArgs(ctypes.Structure):
    """ctypes mirror of csrc/network_update.cu's NetworkArgs."""

    _fields_ = [
        ("n", ctypes.c_longlong),
        ("ispecies", ctypes.c_int),
        ("anydust", ctypes.c_int),
        ("with_radiative_cooling", ctypes.c_int),
        ("deuterium_coupled", ctypes.c_int),
        ("max_iterations", ctypes.c_int),
        ("compensated", ctypes.c_int),
        ("rt", ctypes.c_int),
        ("rt_hydrogen_only", ctypes.c_int),
        ("grid", ctypes.c_int),
        ("dt", ctypes.c_void_p),
        ("tolerance", ctypes.c_double),
        ("tiny8", ctypes.c_double),
        ("huge8", ctypes.c_double),
        ("acc", ctypes.c_double),
        ("gamma_m1", ctypes.c_double),
        ("t_start_101", ctypes.c_double),
        ("scalar", ctypes.c_void_p * N_SCALAR),
        ("inp", ctypes.c_void_p * N_IN),
        ("out", ctypes.c_void_p * N_OUT),
    ]


library = Library(
    "network kernel", SOURCE, NVCC_FLAGS, _NetworkArgs,
    "grackle_network_slots",
    {"in slots": N_IN, "out slots": N_OUT, "scalar slots": N_SCALAR,
     "tile": TILE},
    {"update": "grackle_network_update"})

#: per device index: (SMs, CTAs per SM of the float32 and the float64
#: kernel)
_devices: dict = {}
_devices_lock = threading.Lock()


def _device_limits(index):
    """The SM count of one device and the resident CTAs per SM of each
    kernel; queried once per device (host threads may launch at once)."""
    lib = library.load()
    with _devices_lock:
        if index not in _devices:
            vals = [ctypes.c_int() for _ in range(3)]
            init = lib.grackle_network_init
            init.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
            with torch.cuda.device(index):
                err = init(*map(ctypes.byref, vals))
            sms, ctas64, ctas32 = (v.value for v in vals)
            if err != 0 or min(ctas64, ctas32) < 1:
                raise RuntimeError(f"network kernel set-up failed: CUDA "
                                   f"error {err}, {ctas64}/{ctas32} CTAs "
                                   f"per SM")
            _devices[index] = (sms, ctas32, ctas64)
        return _devices[index]


def input_slots(cfg) -> list[int]:
    """Indices into IN_SLOTS of the operands a launch for ``cfg`` reads.
    The other slots stay null: never passed, never read."""
    ispecies = cfg.primordial_chemistry
    if ispecies not in (0, 1, 2, 3):
        raise ValueError(f"network kernel: primordial_chemistry = "
                         f"{ispecies} is not 0-3")
    anydust = (cfg.h2_on_dust > 0) or (cfg.dust_chemistry > 0)
    fields = {"density", "energy"}
    fields.update(SPECIES_SLOTS[:(0, 6, 9, 12)[ispecies]])
    if cfg.use_radiative_transfer == 1 and ispecies > 0:
        fields.update(RT_SLOTS[:1 if cfg.radiative_transfer_hydrogen_only
                               else 3])
    used = [j for j, name in enumerate(FIELD_SLOTS) if name in fields]
    # k1-k58 from chemistry 1, k7-n_cr_d2 from 2, k50-k56 from 3
    used += [_K0 + j for j in range((0, 8, 25, len(K_SLOTS))[ispecies])]
    used += [_SHIELD0 + j for j in range((0, 3, 7, 7)[ispecies])]
    if anydust and ispecies > 1:
        used.append(_H2DUST)
    used += [_COOL0 + j for j in range(len(COOL_SLOTS))]
    used += [_CARRY0 + j for j, name in enumerate(CARRY_SLOTS)
             if cfg.compensated_sums == 1 or name not in COMPENSATED_SLOTS]
    if ispecies > 1:
        used.append(_H2_LIMIT)
    return used


def slot_dtype(j, dtype):
    """Element type of input slot ``j`` in a launch of float ``dtype``."""
    return FLAG_DTYPES.get(IN_SLOTS[j], dtype) if j >= _CARRY0 else dtype


def _input(j, f, rs, cool_v, carry_v, h2_limit):
    """(tensor, label) of input slot ``j``."""
    name = IN_SLOTS[j]
    if j < _K0:
        return f[name], name
    if j < _SHIELD0:
        return rs.k[name], name
    if j < _H2DUST:
        return rs.shields[name], f"shield {name}"
    if j == _H2DUST:
        return rs.h2dust, "h2dust"
    if j < _CARRY0:
        return cool_v[name], f"cool {name}"
    if j < _H2_LIMIT:
        return carry_v[name], f"carry {name}"
    return h2_limit, "h2_limit"


def prepare_launch(cfg, us, dt, f, rs, cool_v, carry_v, h2_limit):
    """Check the operands of one network-region launch, allocate its
    outputs and size its grid.  Returns ``(launch, result)``: ``launch()``
    runs the kernel on the current stream, writing ``result`` (the carry
    dict ``network_update`` returns), and counts the launch (``library``).
    ``launch.bytes`` is what one launch must move, each operand read once
    and each result written once (kernel_lib.Library.bind);
    ``launch.grid`` the CTAs and ``launch.ctas_per_sm`` how many are
    resident on one SM.  Every tensor
    must be a contiguous [N] CUDA tensor of one device, at any offset;
    the float operands share one dtype (float32 or float64).  ``us.dom``,
    ``us.chunit`` and the shields' ``k27`` are 0-d tensors of that dtype
    on that device (views of the call's scalar block), which the kernel
    reads from device memory."""
    slots = input_slots(cfg)
    ispecies = cfg.primordial_chemistry
    compensated = cfg.compensated_sums == 1
    ref = f["density"]
    dtype, device, n = ref.dtype, ref.device, ref.shape[0]
    library.require_cuda(device)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"network kernel takes float32/float64, got {dtype}")
    operands = []

    def check(t, name, want):
        if (not isinstance(t, torch.Tensor) or t.device != device
                or t.dtype != want or t.shape != (n,)
                or not t.is_contiguous()):
            got = (f"{type(t).__name__}" if not isinstance(t, torch.Tensor)
                   else f"{t.dtype} {tuple(t.shape)} on {t.device}, "
                        f"contiguous={t.is_contiguous()}")
            raise ValueError(
                f"network kernel operand {name}: want a contiguous {want} "
                f"[{n}] tensor on {device}, got {got}")
        operands.append(t)
        return t.data_ptr()

    ptrs = [None] * N_IN
    for j in slots:
        t, label = _input(j, f, rs, cool_v, carry_v, h2_limit)
        ptrs[j] = check(t, label, slot_dtype(j, dtype))

    species = SPECIES_SLOTS[:(0, 6, 9, 12)[ispecies]]
    fields_out = {name: torch.empty_like(ref) for name in
                  ["energy"] + species}
    carry_out = {name: torch.empty(n, dtype=FLAG_DTYPES.get(name, dtype),
                                   device=device)
                 for name in CARRY_SLOTS
                 if compensated or name not in COMPENSATED_SLOTS}
    optrs = [None] * N_OUT
    for j, name in enumerate(OUT_FIELD_SLOTS):
        if name in fields_out:
            optrs[j] = fields_out[name].data_ptr()
    for j, name in enumerate(OUT_CARRY_SLOTS):
        if name in carry_out:
            optrs[len(OUT_FIELD_SLOTS) + j] = carry_out[name].data_ptr()
    # the kernel reads dt and the scalars from device memory (a graph
    # replays with new ones)
    dt = as_dt(dt, ref)
    operands += [*fields_out.values(), *carry_out.values(), dt]
    scalars = {"dom": us.dom, "chunit": us.chunit}
    if ispecies > 0:
        scalars["k27"] = rs.shields["k27"]
    sptrs = [None] * N_SCALAR
    for name, t in scalars.items():
        if (not isinstance(t, torch.Tensor) or t.shape != ()
                or t.device != device or t.dtype != dtype):
            got = (type(t).__name__ if not isinstance(t, torch.Tensor)
                   else f"{t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(f"network kernel scalar {name}: want a 0-d "
                             f"{dtype} tensor on {device}, got {got}")
        sptrs[SCALAR_SLOTS.index(name)] = t.data_ptr()
        operands.append(t)

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    sms, *ctas = _device_limits(index)
    ctas_per_sm = ctas[int(dtype == torch.float64)]
    grid = max(1, min(-(-n // TILE), ctas_per_sm * sms))

    tolerance = dtype_tolerance(dtype)
    args = _NetworkArgs(
        n=n, ispecies=ispecies,
        anydust=int(cfg.h2_on_dust > 0 or cfg.dust_chemistry > 0),
        with_radiative_cooling=int(cfg.with_radiative_cooling),
        deuterium_coupled=int(cfg.deuterium_coupled_solve),
        max_iterations=int(cfg.max_iterations),
        compensated=int(compensated),
        rt=int(cfg.use_radiative_transfer == 1),
        rt_hydrogen_only=int(cfg.radiative_transfer_hydrogen_only),
        grid=grid, dt=dt.data_ptr(), tolerance=tolerance,
        tiny8=dtype_tiny8(dtype), huge8=dtype_huge8(dtype),
        acc=float(cfg.subcycle_accuracy),
        gamma_m1=cfg.Gamma - 1.0,
        t_start_101=1.01 * cfg.TemperatureStart,
    )
    args.scalar[:] = sptrs
    args.inp[:] = ptrs
    args.out[:] = optrs

    launch = library.bind("update", args, dtype, device, operands)
    launch.grid = grid
    launch.ctas_per_sm = ctas_per_sm
    return launch, dict(fields=fields_out, **carry_out)


def network_update_cuda(cfg, us, dt, f, rs, cool_v, carry_v, h2_limit):
    """ops/network.py ``network_update`` as one CUDA launch; same
    arguments, same returned carry.  ``library`` counts the launch."""
    launch, result = prepare_launch(cfg, us, dt, f, rs, cool_v, carry_v,
                                    h2_limit)
    launch()
    return result


_runs_kernel = functools.partial(runs_kernel, what="network region")


def network_update(cfg, us, dt, f, rs, cool_v, carry_v, h2_limit):
    """The network region for one subcycle: the CUDA kernel for CUDA
    tensors, the plain twin (ops/network.py) for CPU tensors."""
    args = (cfg, us, dt, f, rs, cool_v, carry_v, h2_limit)
    if _runs_kernel(f["density"].device):
        return network_update_cuda(*args)
    return _plain.network_update(*args)
