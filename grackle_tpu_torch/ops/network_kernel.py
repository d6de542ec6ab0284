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
stream.  See the source's header for what bounds it and why it is shaped
as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from . import network as _plain
from .common import dtype_huge8, dtype_tiny8, dtype_tolerance

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
#: output slots, in the order of csrc/network_update.cu's enum Out
OUT_FIELD_SLOTS = ["energy"] + SPECIES_SLOTS
OUT_CARRY_SLOTS = CARRY_SLOTS
N_OUT = len(OUT_FIELD_SLOTS) + len(OUT_CARRY_SLOTS)
#: carry slots that only compensated_sums = 1 uses
COMPENSATED_SLOTS = ["energy_lo", "ttot_lo"]


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
        ("dt", ctypes.c_double),
        ("half_dt", ctypes.c_double),
        ("tol_dt", ctypes.c_double),
        ("tiny8", ctypes.c_double),
        ("huge8", ctypes.c_double),
        ("dom", ctypes.c_double),
        ("chunit", ctypes.c_double),
        ("k27", ctypes.c_double),
        ("acc", ctypes.c_double),
        ("gamma_m1", ctypes.c_double),
        ("t_start_101", ctypes.c_double),
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


def library_path() -> str:
    """Where the kernel library for the current source is built: the
    file name carries a hash of the source and flags, so an edited source
    is rebuilt."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libnetwork_update-{digest}.so")


def build() -> str:
    """Compile csrc/network_update.cu with nvcc (if not yet built) and
    return the library path.  Raises if nvcc fails."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            "nvcc failed to build the network kernel:\n"
            + " ".join(cmd) + "\n" + res.stdout + res.stderr
        )
    os.replace(tmp, out)
    build_log = res.stdout + res.stderr
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.grackle_network_slots.argtypes = [
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.grackle_network_slots.restype = ctypes.c_int
            lib.grackle_network_update.argtypes = [
                ctypes.POINTER(_NetworkArgs), ctypes.c_int,
                ctypes.c_void_p]
            lib.grackle_network_update.restype = ctypes.c_int
            n_in, n_out = ctypes.c_int(), ctypes.c_int()
            size = lib.grackle_network_slots(ctypes.byref(n_in),
                                             ctypes.byref(n_out))
            if (n_in.value, n_out.value, size) != (
                    N_IN, N_OUT, ctypes.sizeof(_NetworkArgs)):
                raise RuntimeError(
                    "network kernel layout mismatch: library has "
                    f"{n_in.value} in / {n_out.value} out slots and a "
                    f"{size}-byte argument struct, the wrapper "
                    f"{N_IN} / {N_OUT} / {ctypes.sizeof(_NetworkArgs)}"
                )
            _lib = lib
    return _lib


def prepare_launch(cfg, us, dt, f, rs, cool_v, carry_v, h2_limit):
    """Check the operands of one network-region launch and allocate its
    outputs.  Returns ``(launch, result)``: ``launch()`` runs the kernel
    on the current stream, writing ``result`` (the carry dict
    ``network_update`` returns), and counts nothing; ``launch.bytes`` is
    what one launch must move, each operand read once and each result
    written once.  Every tensor must be a contiguous [N] CUDA tensor of
    one device; the float operands share one dtype (float32 or
    float64)."""
    ispecies = cfg.primordial_chemistry
    if ispecies not in (0, 1, 2, 3):
        raise ValueError(f"network kernel: primordial_chemistry = "
                         f"{ispecies} is not 0-3")
    anydust = (cfg.h2_on_dust > 0) or (cfg.dust_chemistry > 0)
    compensated = cfg.compensated_sums == 1
    rt = cfg.use_radiative_transfer == 1
    ref = f["density"]
    dtype, device, n = ref.dtype, ref.device, ref.shape[0]
    if device.type != "cuda":
        raise ValueError(f"network_update_cuda needs CUDA tensors, got "
                         f"{device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"network kernel takes float32/float64, got {dtype}")

    species = SPECIES_SLOTS[:(0, 6, 9, 12)[ispecies]]
    rt_used = []
    if rt and ispecies > 0:
        rt_used = RT_SLOTS[:1 if cfg.radiative_transfer_hydrogen_only
                           else 3]
    k_used = ((K_SLOTS[:8] if ispecies > 0 else [])
              + (K_SLOTS[8:25] if ispecies > 1 else [])
              + (K_SLOTS[25:] if ispecies > 2 else []))
    sh_used = SHIELD_SLOTS[:(0, 3, 7, 7)[ispecies]]
    carry_used = [name for name in CARRY_SLOTS
                  if compensated or name not in COMPENSATED_SLOTS]
    want = {"itmask": torch.bool, "capped": torch.bool,
            "cell_it": torch.int32}
    moved = 0

    def check(t, name, want=dtype):
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
    base = 0
    for j, name in enumerate(FIELD_SLOTS):
        if name in ("density", "energy") or name in species + rt_used:
            ptrs[base + j] = check(f[name], name)
    base += len(FIELD_SLOTS)
    for j, name in enumerate(K_SLOTS):
        if name in k_used:
            ptrs[base + j] = check(rs.k[name], name)
    base += len(K_SLOTS)
    for j, name in enumerate(SHIELD_SLOTS):
        if name in sh_used:
            ptrs[base + j] = check(rs.shields[name], f"shield {name}")
    base += len(SHIELD_SLOTS)
    if anydust and ispecies > 1:
        ptrs[base] = check(rs.h2dust, "h2dust")
    base += 1
    for j, name in enumerate(COOL_SLOTS):
        ptrs[base + j] = check(cool_v[name], f"cool {name}")
    base += len(COOL_SLOTS)
    for j, name in enumerate(CARRY_SLOTS):
        if name in carry_used:
            ptrs[base + j] = check(carry_v[name], f"carry {name}",
                                   want.get(name, dtype))
    base += len(CARRY_SLOTS)
    if ispecies > 1:
        ptrs[base] = check(h2_limit, "h2_limit")

    fields_out = {name: torch.empty_like(ref) for name in
                  ["energy"] + species}
    carry_out = {name: torch.empty(n, dtype=want.get(name, dtype),
                                   device=device)
                 for name in carry_used}
    optrs = [None] * N_OUT
    for j, name in enumerate(OUT_FIELD_SLOTS):
        if name in fields_out:
            optrs[j] = fields_out[name].data_ptr()
    for j, name in enumerate(OUT_CARRY_SLOTS):
        if name in carry_out:
            optrs[len(OUT_FIELD_SLOTS) + j] = carry_out[name].data_ptr()
    moved += sum(t.element_size() * n for t in
                 list(fields_out.values()) + list(carry_out.values()))

    tolerance = dtype_tolerance(dtype)
    args = _NetworkArgs(
        n=n, ispecies=ispecies, anydust=int(anydust),
        with_radiative_cooling=int(cfg.with_radiative_cooling),
        deuterium_coupled=int(cfg.deuterium_coupled_solve),
        max_iterations=int(cfg.max_iterations),
        compensated=int(compensated), rt=int(rt),
        rt_hydrogen_only=int(cfg.radiative_transfer_hydrogen_only),
        dt=float(dt), half_dt=0.5 * dt, tol_dt=tolerance * dt,
        tiny8=dtype_tiny8(dtype), huge8=dtype_huge8(dtype),
        dom=float(us.dom), chunit=float(us.chunit),
        k27=float(rs.shields["k27"]) if ispecies > 0 else 0.0,
        acc=float(cfg.subcycle_accuracy),
        gamma_m1=cfg.Gamma - 1.0,
        t_start_101=1.01 * cfg.TemperatureStart,
    )
    args.inp[:] = ptrs
    args.out[:] = optrs
    lib = load()
    is_double = int(dtype == torch.float64)

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.grackle_network_update(
                ctypes.byref(args), is_double, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"network kernel launch failed: CUDA error "
                               f"{err}")

    launch.bytes = moved
    return launch, dict(fields=fields_out, **carry_out)


def network_update_cuda(cfg, us, dt, f, rs, cool_v, carry_v, h2_limit):
    """ops/network.py ``network_update`` as one CUDA launch; same
    arguments, same returned carry.  Counts each launch in
    ``network_update_cuda.launches``."""
    launch, result = prepare_launch(cfg, us, dt, f, rs, cool_v, carry_v,
                                    h2_limit)
    launch()
    network_update_cuda.launches += 1
    return result


network_update_cuda.launches = 0


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
