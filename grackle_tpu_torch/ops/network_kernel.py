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
package, into ``grackle_tpu_torch/_build/`` (a shared library with a plain
C interface, loaded with ctypes), and launched on PyTorch's current
stream.  It is a persistent grid of CTAs, one cell a thread; this module
picks the operands a configuration reads (:func:`input_slots`) and sizes
the grid.  See the source's header for what bounds the kernel and why it
is shaped as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from . import network as _plain
from .common import as_dt, dtype_huge8, dtype_tiny8, dtype_tolerance

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "network_update.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction, IEEE division/sqrt, no flush-to-zero: each
    # operation rounds as the plain twin's separate PyTorch op does
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
    # report registers, shared memory and spills in the build log
    "-Xptxas=-v",
]

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


_lib = None
_lib_lock = threading.Lock()
#: compiler output of this process's build ("" when the library existed)
build_log = ""


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def library_path(source=SOURCE, flags=NVCC_FLAGS) -> str:
    """Where the library of ``source`` built with ``flags`` goes: the file
    name carries a hash of the source and flags, so an edited source is
    rebuilt."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join(flags).encode()
        ).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def compile_library(source, flags) -> tuple[str, str]:
    """Compile ``source`` with nvcc into a shared library (if not yet
    built).  Returns (library path, compiler output; "" when the library
    existed).  Raises if nvcc fails."""
    out = library_path(source, flags)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", tmp, source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {os.path.basename(source)}:\n"
            + " ".join(cmd) + "\n" + res.stdout + res.stderr
        )
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def build() -> str:
    """Compile csrc/network_update.cu with nvcc (if not yet built) and
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
            lib.grackle_network_slots.argtypes = [cint_p] * 3
            lib.grackle_network_slots.restype = ctypes.c_int
            lib.grackle_network_init.argtypes = [cint_p] * 4
            lib.grackle_network_init.restype = ctypes.c_int
            lib.grackle_network_update.argtypes = [
                ctypes.POINTER(_NetworkArgs), ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.grackle_network_update.restype = ctypes.c_int
            n_in, n_out, n_scalar = (ctypes.c_int() for _ in range(3))
            size = lib.grackle_network_slots(ctypes.byref(n_in),
                                             ctypes.byref(n_out),
                                             ctypes.byref(n_scalar))
            if (n_in.value, n_out.value, n_scalar.value, size) != (
                    N_IN, N_OUT, N_SCALAR, ctypes.sizeof(_NetworkArgs)):
                raise RuntimeError(
                    "network kernel layout mismatch: library has "
                    f"{n_in.value} in / {n_out.value} out / "
                    f"{n_scalar.value} scalar slots and a {size}-byte "
                    f"argument struct, the wrapper {N_IN} / {N_OUT} / "
                    f"{N_SCALAR} / {ctypes.sizeof(_NetworkArgs)}"
                )
            _lib = lib
    return _lib


#: per device index: (SMs, CTAs per SM of the float32 and the float64
#: kernel)
_devices: dict = {}


def _device_limits(lib, index):
    """The SM count of one device and the resident CTAs per SM of each
    kernel; queried once per device, under the library's lock (host
    threads may launch at once)."""
    with _lib_lock:
        if index not in _devices:
            vals = [ctypes.c_int() for _ in range(4)]
            with torch.cuda.device(index):
                err = lib.grackle_network_init(*map(ctypes.byref, vals))
            tile, sms, ctas64, ctas32 = (v.value for v in vals)
            if err != 0 or min(ctas64, ctas32) < 1:
                raise RuntimeError(f"network kernel set-up failed: CUDA "
                                   f"error {err}, {ctas64}/{ctas32} CTAs "
                                   f"per SM")
            if tile != TILE:
                raise RuntimeError(f"network kernel layout mismatch: "
                                   f"library tiles {tile} cells, the "
                                   f"wrapper {TILE}")
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
    dict ``network_update`` returns), and counts nothing.
    ``launch.bytes`` is what one launch must move, each operand read once
    and each result written once; ``launch.grid`` the CTAs and
    ``launch.ctas_per_sm`` how many are resident on one SM.  Every tensor
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
    if device.type != "cuda":
        raise ValueError(f"network_update_cuda needs CUDA tensors, got "
                         f"{device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"network kernel takes float32/float64, got {dtype}")
    moved = 0

    def check(t, name, want):
        nonlocal moved
        if (not isinstance(t, torch.Tensor) or t.device != device
                or t.dtype != want or t.shape != (n,)
                or not t.is_contiguous()):
            got = (f"{type(t).__name__}" if not isinstance(t, torch.Tensor)
                   else f"{t.dtype} {tuple(t.shape)} on {t.device}, "
                        f"contiguous={t.is_contiguous()}")
            raise ValueError(
                f"network kernel operand {name}: want a contiguous {want} "
                f"[{n}] tensor on {device}, got {got}")
        moved += t.element_size() * n
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
    moved += sum(t.element_size() * n for t in
                 list(fields_out.values()) + list(carry_out.values()))
    # the kernel reads dt and the scalars from device memory (a graph
    # replays with new ones)
    dt = as_dt(dt, ref)
    moved += dt.element_size()
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
        moved += t.element_size()

    lib = load()
    is_double = int(dtype == torch.float64)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    sms, *ctas = _device_limits(lib, index)
    ctas_per_sm = ctas[is_double]
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
        dt=dt.data_ptr(), tolerance=tolerance,
        tiny8=dtype_tiny8(dtype), huge8=dtype_huge8(dtype),
        acc=float(cfg.subcycle_accuracy),
        gamma_m1=cfg.Gamma - 1.0,
        t_start_101=1.01 * cfg.TemperatureStart,
    )
    args.scalar[:] = sptrs
    args.inp[:] = ptrs
    args.out[:] = optrs

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.grackle_network_update(
                ctypes.byref(args), is_double, grid,
                ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"network kernel launch failed: CUDA error "
                               f"{err}")

    # the kernel reads these at every launch
    launch.dt = dt
    launch.scalars = scalars
    launch.bytes = moved
    launch.grid = grid
    launch.ctas_per_sm = ctas_per_sm
    return launch, dict(fields=fields_out, **carry_out)


def network_update_cuda(cfg, us, dt, f, rs, cool_v, carry_v, h2_limit):
    """ops/network.py ``network_update`` as one CUDA launch; same
    arguments, same returned carry.  Counts each launch: an eager one in
    ``network_update_cuda.launches``; one recorded into a CUDA graph, on
    the device at every replay, where :func:`count_replays` armed a
    counter for the device before the capture."""
    launch, result = prepare_launch(cfg, us, dt, f, rs, cool_v, carry_v,
                                    h2_limit)
    launch()
    if torch.cuda.is_current_stream_capturing():
        # the launch is recorded, not run: a node beside it counts it
        # each time it runs (atomically: graphs replay on several streams)
        armed = _replay_counters.get(_device_index(launch.dt.device))
        if armed is not None:
            count, index, one = armed
            count.index_add_(0, index, one)
    else:
        network_update_cuda.launches += 1
    return result


network_update_cuda.launches = 0
#: per device index: (count, index, one), int64 tensors of one element on
#: that device, where count_replays armed the device's replay count
_replay_counters: dict = {}


def _device_index(device) -> int:
    device = torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def count_replays(device):
    """Count on ``device`` the network launches that CUDA graphs captured
    from now on make when they replay (graphs captured before are not
    counted); a no-op off the card and where the device already counts.
    Not inside a capture."""
    if torch.device(device).type != "cuda":
        return
    index = _device_index(device)
    if index not in _replay_counters:
        dev = torch.device("cuda", index)
        _replay_counters[index] = (
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.ones(1, dtype=torch.int64, device=dev))


def replayed_launches() -> int:
    """The network launches that graphs replayed since the counts were
    armed or zeroed, summed over the devices (reads them on the host)."""
    return sum(int(count) for count, _, _ in _replay_counters.values())


def zero_launch_counts():
    """Set the host count and every device's replay count to 0."""
    network_update_cuda.launches = 0
    for count, _, _ in _replay_counters.values():
        count.zero_()


def network_update(cfg, us, dt, f, rs, cool_v, carry_v, h2_limit):
    """The network region for one subcycle: the CUDA kernel for CUDA
    tensors, the plain twin (ops/network.py) for CPU tensors."""
    device = f["density"].device
    if device.type == "cuda":
        return network_update_cuda(cfg, us, dt, f, rs, cool_v, carry_v,
                                   h2_limit)
    if device.type == "cpu":
        return _plain.network_update(cfg, us, dt, f, rs, cool_v, carry_v,
                                     h2_limit)
    raise ValueError(f"no network region for device {device}")
