"""Conditional WHILE nodes of a CUDA graph, and the loop's condition
kernel (csrc/graph_loop.cu), loaded with ctypes.

ops/device_loop.py drives a loop through this module when the current
stream is capturing a CUDA graph: :func:`handle` makes the node's
condition handle, :func:`cond` launches the condition kernel (its plain
version is :func:`plain_predicate`), :func:`begin` adds the WHILE node and
starts capturing its body on another stream, :func:`end` ends it;
:func:`capture_id`, :func:`retain` and :func:`released` let the caller
keep a capture's memory until its graph is destroyed.  The
library is built at first use with ``nvcc`` for sm_90a from the source in
this package, into ``grackle_tpu_torch/_build/``, as the other kernels
are (ops/kernel_lib.py).  A runtime or driver older than CUDA 12.4
has no conditional nodes: :func:`load` raises and names both versions.
There is no eager substitute for a node inside a capture.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .kernel_lib import PKG_DIR, compile_library

SOURCE = os.path.join(PKG_DIR, "csrc", "graph_loop.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
#: the first CUDA version with conditional WHILE nodes, as the runtime
#: reports it (1000 * major + 10 * minor)
MIN_CUDA = 12040

_lib = None
_lib_lock = threading.Lock()
#: compiler output of this process's build ("" when the library existed)
build_log = ""
#: (runtime, driver) CUDA versions of the loaded library
versions = None


def _version(v):
    return f"{v // 1000}.{v % 1000 // 10}"


def build() -> str:
    """Compile csrc/graph_loop.cu with nvcc (if not yet built) and return
    the library path.  Raises if nvcc fails."""
    global build_log
    out, log = compile_library(SOURCE, NVCC_FLAGS)
    if log:
        build_log = log
    return out


def load():
    """The loaded library (built on first call).  Raises when the CUDA
    runtime it was built with or the driver predates conditional WHILE
    nodes."""
    global _lib, versions
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            u64, vp = ctypes.c_ulonglong, ctypes.c_void_p
            cint_p = ctypes.POINTER(ctypes.c_int)
            lib.grackle_loop_versions.argtypes = [cint_p, cint_p]
            lib.grackle_loop_handle.argtypes = [vp, ctypes.POINTER(u64)]
            lib.grackle_loop_begin.argtypes = [vp, vp, u64]
            lib.grackle_loop_end.argtypes = [vp, ctypes.POINTER(u64)]
            lib.grackle_loop_cond.argtypes = [
                vp, ctypes.c_longlong, vp, ctypes.c_longlong,
                ctypes.c_longlong, u64, ctypes.c_int, vp, vp, vp]
            lib.grackle_graph_nodes.argtypes = [vp, ctypes.POINTER(u64)]
            lib.grackle_capture_nodes.argtypes = [vp, ctypes.POINTER(u64)]
            lib.grackle_loop_capture_id.argtypes = [vp, ctypes.POINTER(u64)]
            lib.grackle_loop_retain.argtypes = [vp]
            lib.grackle_loop_released.argtypes = [ctypes.POINTER(u64),
                                                  ctypes.c_int]
            for fn in ("versions", "handle", "begin", "end", "cond",
                       "capture_id", "retain", "released"):
                getattr(lib, f"grackle_loop_{fn}").restype = ctypes.c_int
            lib.grackle_graph_nodes.restype = ctypes.c_int
            lib.grackle_capture_nodes.restype = ctypes.c_int
            rt, drv = ctypes.c_int(), ctypes.c_int()
            _check(lib.grackle_loop_versions(ctypes.byref(rt),
                                             ctypes.byref(drv)), "versions")
            if min(rt.value, drv.value) < MIN_CUDA:
                raise RuntimeError(
                    f"CUDA graph conditional WHILE nodes need CUDA "
                    f"{_version(MIN_CUDA)} or later: this library's runtime "
                    f"is {_version(rt.value)}, the driver "
                    f"{_version(drv.value)}")
            versions = (rt.value, drv.value)
            _lib = lib
    return _lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"graph loop {what} failed: CUDA error {err}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def handle(device) -> int:
    """A new condition handle in the graph the current stream of
    ``device`` is capturing."""
    h = ctypes.c_ulonglong()
    _check(load().grackle_loop_handle(_stream(device), ctypes.byref(h)),
           "handle (is the stream capturing?)")
    return h.value


def begin(device, body_stream, handle_):
    """Add a WHILE node on ``handle_`` after the work captured so far on
    the current stream of ``device`` and start capturing ``body_stream``
    (a torch.cuda.Stream) into its body."""
    _check(load().grackle_loop_begin(
        _stream(device), ctypes.c_void_p(body_stream.cuda_stream),
        ctypes.c_ulonglong(handle_)), "begin")


def end(body_stream) -> int:
    """End the body's capture; returns the body graph's own node count."""
    nodes = ctypes.c_ulonglong()
    _check(load().grackle_loop_end(ctypes.c_void_p(body_stream.cuda_stream),
                                   ctypes.byref(nodes)), "end")
    return nodes.value


def capture_id(device) -> int:
    """The id of the capture the current stream of ``device`` belongs to
    (unique in the process)."""
    cid = ctypes.c_ulonglong()
    _check(load().grackle_loop_capture_id(_stream(device), ctypes.byref(cid)),
           "capture id (is the stream capturing?)")
    return cid.value


def retain(device):
    """Have the graph the current stream of ``device`` is capturing report
    its capture id to :func:`released` once it, and every executable
    graph made from it, is destroyed."""
    _check(load().grackle_loop_retain(_stream(device)), "retain")


def released() -> list:
    """The ids of captures whose graphs were destroyed since the last
    call."""
    ids = (ctypes.c_ulonglong * 64)()
    out = []
    while True:
        n = load().grackle_loop_released(ids, len(ids))
        out.extend(ids[:n])
        if n < len(ids):
            return out


def graph_nodes(graph) -> int:
    """The own node count of a cudaGraph_t (``CUDAGraph.raw_cuda_graph()``);
    a conditional node counts as one."""
    count = ctypes.c_ulonglong()
    _check(load().grackle_graph_nodes(ctypes.c_void_p(graph),
                                      ctypes.byref(count)), "node count")
    return count.value


def capture_nodes(device) -> int:
    """The own node count, so far, of the graph the current stream of
    ``device`` is capturing (tracing.shield_block reads it before and
    after a block)."""
    count = ctypes.c_ulonglong()
    _check(load().grackle_capture_nodes(_stream(device), ctypes.byref(count)),
           "capture node count (is the stream capturing?)")
    return count.value


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def cond(mask, step, advance, cap, handle_=None, value_out=None,
         launches=None):
    """One launch of the condition kernel on the current stream:
    ``step += advance``, then ``any(mask) and step < cap`` set on
    ``handle_`` (if given) and written to ``value_out`` (an int32 tensor,
    if given); ``launches`` (an int64 tensor, if given) counts the
    kernel's launches on the device.  ``mask`` is a contiguous bool
    tensor, ``step`` a 0-d int64 tensor, both on one CUDA device.  Counts
    each launch in ``cond.launches``."""
    if (mask.device.type != "cuda" or mask.dtype != torch.bool
            or not mask.is_contiguous()):
        raise ValueError(f"graph loop condition: want a contiguous bool "
                         f"CUDA mask, got {mask.dtype} on {mask.device}")
    for t, want in ((step, torch.int64), (value_out, torch.int32),
                    (launches, torch.int64)):
        if t is not None and (t.device != mask.device or t.dtype != want
                              or t.numel() != 1):
            raise ValueError(f"graph loop condition: want one {want} on "
                             f"{mask.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    with torch.cuda.device(mask.device):
        err = load().grackle_loop_cond(
            _ptr(mask), mask.numel(), _ptr(step), advance, cap,
            ctypes.c_ulonglong(handle_ or 0), int(handle_ is not None),
            _ptr(value_out), _ptr(launches), _stream(mask.device))
    _check(err, "condition kernel launch")
    cond.launches += 1


cond.launches = 0


def plain_predicate(mask, step, advance, cap):
    """The condition kernel's plain version: ``step + advance`` and
    ``mask.any() & (step + advance < cap)``, as tensors."""
    step = step + advance
    return step, mask.any() & (step < cap)
