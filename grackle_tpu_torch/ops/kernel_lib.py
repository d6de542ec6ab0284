"""What the port's hand-written CUDA kernels share: the nvcc build into
``grackle_tpu_torch/_build/``, a ctypes library whose argument layout is
checked against its wrapper's and whose launches are counted, and the
autograd plumbing by which a launch's backward is its plain twin's.

A launch is counted on the host when it is issued, eager or recorded into
a CUDA-graph capture.  Where :meth:`ReplayCounter.arm` armed the device
before a capture, the graph also counts its launches on the device at
every replay, so the launches that ran on the card can be read back.
:func:`count_replays`, :func:`zero_counts`, :func:`replayed` and
:func:`executed` do so for every library at once.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
#: nvcc's flags for a kernel whose every operation rounds as the plain
#: twin's separate PyTorch op does (the network kernel)
EXACT_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction, IEEE division/sqrt, no flush-to-zero
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
    # report registers, shared memory and spills in the build log
    "-Xptxas=-v",
]
#: EXACT_FLAGS but for FMA contraction, left at nvcc's default as in
#: PyTorch's own build, for a kernel that calls CUDA's pow (the Cloudy
#: and the dust kernels): pow rounds differently under -fmad=false (an
#: ulp in 12 of chip_smoke phase 2c's 504 card checks, PERF.md).  Such a
#: kernel writes its own arithmetic as round-to-nearest intrinsics, which
#: no flag contracts
POW_FLAGS = ["-fmad=true" if f == "-fmad=false" else f
             for f in EXACT_FLAGS]


def nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def library_path(source, flags) -> str:
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
    cmd = [nvcc(), *flags, "-o", tmp, source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {os.path.basename(source)}:\n"
            + " ".join(cmd) + "\n" + res.stdout + res.stderr
        )
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def device_index(device) -> int:
    device = torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


class ReplayCounter:
    """A count, on each armed card, of the launches that CUDA graphs make
    when they replay: a launch recorded into a capture on an armed device
    gets a node beside it that adds 1 each time it runs (atomically:
    graphs replay on several streams).  Graphs captured before a device
    was armed are not counted."""

    def __init__(self):
        #: per device index: (count, index, one), int64 tensors of one
        #: element on that device
        self._armed = {}

    def arm(self, device):
        """Count on ``device`` from now on; a no-op off the card and where
        the device already counts.  Not inside a capture."""
        if torch.device(device).type != "cuda":
            return
        index = device_index(device)
        if index not in self._armed:
            dev = torch.device("cuda", index)
            self._armed[index] = (
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.ones(1, dtype=torch.int64, device=dev))

    def record(self, device):
        """Inside a capture, beside a launch recorded on ``device``: the
        counting node, where the device is armed."""
        armed = self._armed.get(device_index(device))
        if armed is not None:
            count, index, one = armed
            count.index_add_(0, index, one)

    def total(self) -> int:
        """The replayed launches since arming or zeroing, summed over the
        devices (reads them on the host)."""
        return sum(int(count) for count, _, _ in self._armed.values())

    def zero(self):
        for count, _, _ in self._armed.values():
            count.zero_()


#: every Library made, in the order made (the package's import makes the
#: Cloudy, the dust and the network kernels')
LIBRARIES = []


class Library:
    """One kernel source with a plain C interface: built with nvcc at
    first use, loaded with ctypes, its layout checked, its entries
    launched on PyTorch's current stream and counted.

    The source exports ``layout``, which writes one int for each value of
    ``want`` (slot counts, the block size) and returns the size of the
    argument struct that ``args_type`` mirrors, and for each name in
    ``entries`` a C function ``(const Args*, int is_double, void*
    stream) -> int`` that returns the CUDA error after the launch."""

    def __init__(self, what, source, flags, args_type, layout, want,
                 entries):
        self.what, self.source, self.flags = what, source, flags
        self.args_type, self.layout, self.want = args_type, layout, want
        self.entries = entries
        #: compiler output of this process's build ("" when the library
        #: existed)
        self.build_log = ""
        #: launches issued on the host since the process started (or
        #: zero()), eager or recorded into a capture, per entry
        self.launches = collections.Counter()
        #: of ``launches``, those recorded into a capture, per entry
        self.recorded = collections.Counter()
        self._replays = ReplayCounter()
        self._lib = None
        self._lock = threading.Lock()
        LIBRARIES.append(self)

    def require_cuda(self, device):
        """Raise unless ``device`` is a CUDA device: the launch helpers'
        first check, before anything is built."""
        if device.type != "cuda":
            raise ValueError(f"the {self.what} needs CUDA tensors, got "
                             f"{device}")

    def build(self) -> str:
        """Compile the source with nvcc (if not yet built) and return the
        library path.  Raises if nvcc fails."""
        out, log = compile_library(self.source, self.flags)
        if log:
            self.build_log = log
        return out

    def load(self):
        """The loaded library (built on first call)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                layout = getattr(lib, self.layout)
                layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(
                    self.want)
                layout.restype = ctypes.c_int
                for name in self.entries.values():
                    fn = getattr(lib, name)
                    fn.argtypes = [ctypes.POINTER(self.args_type),
                                   ctypes.c_int, ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                vals = [ctypes.c_int() for _ in self.want]
                size = layout(*map(ctypes.byref, vals))
                got = tuple(v.value for v in vals) + (size,)
                want = tuple(self.want.values()) + (
                    ctypes.sizeof(self.args_type),)
                if got != want:
                    raise RuntimeError(
                        f"{self.what} layout mismatch: the library has "
                        f"({', '.join(self.want)}, struct bytes) {got}, "
                        f"the wrapper {want}")
                self._lib = lib
        return self._lib

    def bind(self, entry, args, dtype, device, operands):
        """``entry``'s launch with ``args`` on ``device`` as a closure:
        ``launch()`` launches it on the current stream of ``device`` and
        counts it: on the host, and where the launch is recorded into a
        capture on an armed device, on the device at every replay.
        ``operands`` are the per-cell and 0-d tensors it reads and
        writes, held as long as the closure is; ``launch.bytes`` is their
        size, what one launch must move (each read once, each result
        written once)."""
        def launch():
            fn = getattr(self.load(), self.entries[entry])
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                err = fn(ctypes.byref(args), int(dtype == torch.float64),
                         ctypes.c_void_p(stream))
            if err != 0:
                raise RuntimeError(f"{self.what} {entry} launch failed: "
                                   f"CUDA error {err}")
            self.launches[entry] += 1
            if torch.cuda.is_current_stream_capturing():
                self.recorded[entry] += 1
                self._replays.record(device)

        launch.operands = operands
        launch.bytes = sum(t.nbytes for t in operands)
        return launch

    def count_replays(self, device):
        """Count on ``device`` the launches that CUDA graphs captured from
        now on make when they replay; a no-op off the card.  Not inside a
        capture."""
        self._replays.arm(device)

    def replayed(self) -> int:
        """The launches that graphs replayed since the counts were armed
        or zeroed, summed over the devices (reads them on the host)."""
        return self._replays.total()

    def issued(self) -> int:
        """The launches issued on the host, every entry's."""
        return sum(self.launches.values())

    def executed(self) -> int:
        """The launches that ran on the card since the counts were
        zeroed: the eager ones and those that armed graphs replayed."""
        return (self.issued() - sum(self.recorded.values())
                + self.replayed())

    def zero(self):
        """Set the host counts and every device's replay count to 0."""
        self.launches.clear()
        self.recorded.clear()
        self._replays.zero()


def count_replays(device):
    """Arm every library's replay count on ``device`` (a no-op off the
    card).  Not inside a capture."""
    for library in LIBRARIES:
        library.count_replays(device)


def zero_counts():
    """Set every library's launch counts to 0."""
    for library in LIBRARIES:
        library.zero()


def replayed() -> dict:
    """{library.what: the launches that armed graphs replayed since the
    counts were zeroed} for every library."""
    return {library.what: library.replayed() for library in LIBRARIES}


def executed() -> dict:
    """{library.what: the launches that ran on the card since the counts
    were zeroed} for every library."""
    return {library.what: library.executed() for library in LIBRARIES}


def runs_kernel(device, what) -> bool:
    """Whether a call on ``device`` launches a kernel: on CUDA tensors;
    CPU tensors run the twin, other devices raise."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no {what} for device {device}")
    return True


def save_twin_args(ctx, lead, args):
    """Keep a launch's leading constants ``lead`` (a table, or nothing),
    its tensors and its other arguments for its backward."""
    is_tensor = [isinstance(a, torch.Tensor) for a in args]
    ctx.lead, ctx.is_tensor = tuple(lead), is_tensor
    ctx.consts = [None if t else a for a, t in zip(args, is_tensor)]
    ctx.save_for_backward(*(a for a, t in zip(args, is_tensor) if t))


def twin_vjp(ctx, twin, grads):
    """The gradient of every argument after the leading constants (None
    where it needs none): the vector-Jacobian product of ``twin``,
    recomputed on the forward's inputs."""
    saved = iter(ctx.saved_tensors)
    needs = ctx.needs_input_grad[len(ctx.lead):]
    args = [next(saved).detach().requires_grad_(need) if t else a
            for a, t, need in zip(ctx.consts, ctx.is_tensor, needs)]
    with torch.enable_grad():
        outs = twin(*ctx.lead, *args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
    wrt = [a for a, need in zip(args, needs) if need]
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   wrt, [g for _, g in pairs],
                                   allow_unused=True)
               if pairs else [None] * len(wrt))
    return [next(got) if need else None for need in needs]
