"""The stateful entry points captured once and replayed: one CUDA graph
per context, entry, path, width and stream.

The JAX package compiles its stateful entry points with ``jax.jit``, the
frozen configuration a static argument (grackle_tpu/api.py:11-14,
156-297): a call runs one executable, compiled once per configuration
and shape, with no host round trip inside.  This module is the port's
counterpart.  ``api.solve_chemistry`` (and through it
``solve_chemistry_grid``, ``FluidContainer``, ``utilities/evolve``, the
examples, ``yt_fields`` and the C ABI), the five ``api.calculate_*``
and the per-shard solves of ``parallel.sharding`` call :func:`run` with
a key and their body (``api.solve_prepared``, an ``ops/derived``
function).  For one key:

1. the first call runs the body eagerly: it is the warm-up that a
   capture needs (it builds the kernels and sets up CUDA state; see
   ``functional``);
2. the second call clones its inputs into static buffers, captures the
   body on them into a ``torch.cuda.CUDAGraph`` (its loops become
   conditional WHILE nodes, ops/device_loop.py) and replays it;
3. every later call copies its inputs into those buffers and replays.

A replayed call returns clones of the graph's outputs, since the next
replay overwrites them (JAX returns fresh arrays too).  An eager call
clones each output that shares memory with an input (the exact path
hands back the fields it does not change), so no result aliases what
the call was given, and a loop that feeds each call's output back in
sees no aliasing on either path.

The key is the caller's (entry, path, field names and shapes, solver
dtype, whether the metal field and a shielding length are given, the
comoving flag: what the JAX package's jitted cores take as static), plus
the device and its current stream, so that calls on two streams never
share static buffers.  The values a call computes on the host are
inputs, not part of the key: ``dt``, a 0-d float64 tensor, and the
call's scalar block (its ``UnitScalars``, ``PhotoRates`` and code units
in the solver dtype, ops/common.scalar_block), which the body reads
from device memory, the network kernel included.  So a cosmological run
whose ``a_value`` changes every call replays one graph, as the JAX
package, which traces those values, compiles once
(grackle_tpu/ops/common.py:46-164).

Calls that stay eager, whatever their key:

- on the CPU, where the caller asked for the CPU; the results are the
  same;
- while the current stream is capturing: a host capturing
  ``cd.solve_chemistry`` into its own graph gets the solve recorded into
  that graph, as ``functional.make_solve_fn`` is;
- when an input requires grad: a graph records no autograd.

A second call stays eager, too, where its capture might not fit in the
card's memory.  Each eager call of a key on the card records the peak
that its body allocated: the caching allocator's peak counter is reset
before the body (``torch.cuda.reset_peak_memory_stats``, which a host
that reads that counter sees) and read after it, less what was
allocated before.  Under threads that run bodies at once the figure
takes in the others' allocations too.  A capture goes ahead where twice
that peak (the graph's pool and its loop bodies' pools, PERF.md) plus
the static inputs fits in what the card has free together with what the
allocator holds unused; otherwise the call runs eagerly with the same
results, ``calls`` counts it as eager, and a later call captures once
the memory is there.  A capture or a replay that fails all the same
raises: no call falls back to the eager body.

A card holds at most :data:`MAX_GRAPHS` graphs, those of every context
together.  A capture that finds the card full drops the least recently
used graph, unless that graph was called since the new key's previous
call: then the key's calls come round less often than the card's graphs
are used (a host cycling through more patch widths than the bound), and
capturing it would drop a graph that is about to come back, so the key
stays eager.  A dropped graph's pools are freed through
``device_loop.release_pools``, and the graphs die with their context.
One lock serializes the graph path of every context: the calls of one
key share their static buffers (threaded hosts call one context from
several threads, examples/cxx_omp_example.cpp), the capture and
loop-body streams are the process's, and eviction crosses contexts.

The inputs are copied in by name: a dict is flattened in sorted key
order, as the key sorts the field names, so two calls whose fields come
in different orders share one graph and each field its own buffer.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import weakref
from typing import Any

import torch
from torch.utils import _pytree as pytree

from .ops import device_loop

#: graphs a card keeps, every context's together.  Each holds its pools,
#: which bound the number: 1.06 GiB for the f64 flagship at 1,048,576
#: cells, 9.52 GiB on the exact path at that width (NVIDIA H100, PERF.md
#: section 5), so six of the largest leave an 80 GB card room for a new
#: key's eager call.  It covers a hydro code's solve and its five
#: derived fields at one width; a host that cycles through more widths
#: replays six of them and runs the rest eagerly (module docstring)
MAX_GRAPHS = 6
#: keys a context remembers as called eagerly, each with the tick of its
#: last call and its eager peak (host memory only).  Bounded so that a
#: host whose key changes with every call (an AMR code whose patch widths
#: keep changing) does not grow it without end; a key forgotten runs
#: eagerly once more
MAX_SEEN = 64
#: a capture needs about this many times its key's eager peak: the
#: graph's pool and its loop bodies' pools (module docstring)
CAPTURE_PEAKS = 2

#: serializes the graph path of every context (module docstring)
_lock = threading.RLock()
#: every live cache, for the bound per card
_caches: "weakref.WeakSet[GraphCache]" = weakref.WeakSet()
#: counts the calls that take the graph path: when each key and graph was
#: last called
_ticks = itertools.count()


@dataclasses.dataclass
class _Entry:
    graph: Any
    device: str
    spec: Any  # the inputs' tree structure, dicts in sorted key order
    inputs: list  # the static input buffers, in leaf order
    outputs: Any  # what the graph writes on each replay
    keep: Any = None  # what the graph reads besides (a shard's tables)
    used: int = 0  # the tick of its last call


class GraphCache:
    """The captured graphs of one context's stateful calls
    (``api.GrackleContext.graphs``); ``calls`` counts the calls of each
    kind: "eager", "capture" and "replay"."""

    def __init__(self):
        self.calls = collections.Counter()
        self._graphs = collections.OrderedDict()
        self._seen = collections.OrderedDict()
        with _lock:
            _caches.add(self)

    def __len__(self):
        return len(self._graphs)

    def keys(self):
        return list(self._graphs)

    def entry(self, key):
        """The captured entry of a full key (as :meth:`keys` lists it)."""
        return self._graphs[key]

    def _remember(self, key, tick, peak):
        self._seen[key] = (tick, peak)
        self._seen.move_to_end(key)
        while len(self._seen) > MAX_SEEN:
            self._seen.popitem(last=False)


def held(device) -> int:
    """The graphs that every live cache holds on ``device``."""
    return sum(entry.device == str(device) for cache in list(_caches)
               for entry in cache._graphs.values())


def _make_room(device, since) -> bool:
    """Drop the least recently used graphs on ``device`` until a new one
    fits; False, dropping nothing more, where the next to go was called
    after tick ``since`` (the new key's previous call)."""
    while True:
        entries = [(entry.used, cache, key) for cache in list(_caches)
                   for key, entry in cache._graphs.items()
                   if entry.device == device]
        if len(entries) < MAX_GRAPHS:
            return True
        used, cache, key = min(entries, key=lambda e: e[0])
        if used > since:
            return False
        del cache._graphs[key]


def _capture(body, inputs):
    """``body(inputs)`` captured into a new CUDA graph: (graph, outputs).
    Only this thread's unsafe CUDA calls are refused meanwhile: a
    threaded host may run another key's eager call in another thread."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outputs = body(inputs)
    return graph, outputs


def _on_card(device) -> bool:
    """Whether calls with inputs on ``device`` capture graphs."""
    return device.type == "cuda"


def _measured(device, fn):
    """``fn()`` and the bytes it allocated on ``device`` at its peak
    beyond what was allocated before (0 off the card); resets the
    device's peak counter (module docstring)."""
    if device.type != "cuda":
        return fn(), 0
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    return out, max(0, torch.cuda.max_memory_allocated(device) - before)


def _free_bytes(device) -> float:
    """What a capture on ``device`` may allocate: the card's free memory
    and what the caching allocator holds unused (no limit off the
    card)."""
    if device.type != "cuda":
        return float("inf")
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def _fits(device, peak, tensors) -> bool:
    """Whether a key whose eager body peaked at ``peak`` bytes fits a
    capture on ``device`` beside static copies of ``tensors``."""
    need = CAPTURE_PEAKS * peak + sum(t.numel() * t.element_size()
                                      for t in tensors)
    return _free_bytes(device) >= need


def _tensor_leaves(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _map_tensors(fn, tree):
    return pytree.tree_map(
        lambda t: fn(t) if isinstance(t, torch.Tensor) else t, tree)


def _unaliased(outputs, inputs):
    """``outputs`` with every tensor that shares memory with one of
    ``inputs`` cloned."""
    held = {t.untyped_storage().data_ptr() for t in inputs if t.numel()}
    return _map_tensors(
        lambda t: t.clone() if t.numel()
        and t.untyped_storage().data_ptr() in held else t, outputs)


def run(cache: GraphCache, key, body, inputs, keep=None):
    """``body(inputs)`` for a call under ``key``: eager, captured and
    replayed, or replayed, as the module docstring says.  ``inputs`` is
    a pytree of tensors on one device (None leaves allowed), the same
    structure, shapes and dtypes for every call of a key; ``keep`` is
    held as long as the graph (what its nodes read besides the context's
    own tables).  Returns (outputs, the kind of call)."""
    inputs = device_loop._canonical(inputs)
    tensors = _tensor_leaves(inputs)
    device = tensors[0].device
    if (not _on_card(device) or torch.cuda.is_current_stream_capturing()
            or any(t.requires_grad for t in tensors)):
        return _unaliased(body(inputs), tensors), "eager"
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == "cuda" else None)
    key = (key, str(device), stream)
    with _lock:
        device_loop.release_pools()
        tick = next(_ticks)
        entry = cache._graphs.get(key)
        if entry is not None:
            _copy_in(entry, inputs)
            kind = "replay"
        elif (key in cache._seen
              and _fits(device, cache._seen[key][1], tensors)
              and _make_room(str(device), cache._seen[key][0])):
            del cache._seen[key]
            entry = _captured(body, inputs, keep, device)
            cache._graphs[key] = entry
            kind = "capture"
        else:
            kind = "eager"
        cache.calls[kind] += 1
        if entry is not None:
            cache._graphs.move_to_end(key)
            entry.used = tick
            entry.graph.replay()
            return _map_tensors(torch.clone, entry.outputs), kind
    out, peak = _measured(device, lambda: body(inputs))
    with _lock:
        cache._remember(key, tick, peak)
    return _unaliased(out, tensors), kind


def _captured(body, inputs, keep, device):
    """A new entry: ``body`` captured on clones of ``inputs``."""
    device_loop.release_pools()
    static = _map_tensors(lambda t: t.clone(), inputs)
    graph, outputs = _capture(body, static)
    leaves, spec = pytree.tree_flatten(static)
    return _Entry(graph, str(device), spec,
                  [t for t in leaves if isinstance(t, torch.Tensor)],
                  outputs, keep)


def _copy_in(entry, inputs):
    """Copy a call's inputs into the entry's static buffers, leaf by leaf
    in sorted key order; raises where the structure or a shape differs
    from the capture's."""
    leaves, spec = pytree.tree_flatten(inputs)
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    if spec != entry.spec or any(t.shape != buf.shape for t, buf
                                 in zip(tensors, entry.inputs)):
        raise ValueError("graph_cache: a call's inputs differ from the "
                         "captured graph's in structure or shape")
    for buf, t in zip(entry.inputs, tensors):
        buf.copy_(t)
