"""The solve's data-dependent loops, eager or as CUDA-graph WHILE nodes.

The JAX package's loops are device loops (``lax.while_loop``): a host
code compiles the whole solve into its own ``jit`` step.  The port's
loops run eagerly and read their exit condition on the host once a block
of steps; :func:`device_while` is that loop, and the one place that reads
(:func:`host_read`).  When the current stream is capturing a CUDA graph
(``torch.cuda.is_current_stream_capturing()``) the same call records one
conditional WHILE node instead (ops/graph_loop.py): its body is ``block``
steps of ``body`` followed by the condition kernel, which advances a
device step counter and tests "some lane of the mask is set, and the
counter is below the cap" on the device.  Loops nest: a body may run
another :func:`device_while`, which becomes a node inside the body.

Inside a capture:

- the loop's carry lives in buffers cloned from the carry passed in;
  every iteration overwrites them in place, since graph nodes have fixed
  addresses (as PyTorch's own IF nodes do,
  torch/_higher_order_ops/cudagraph_conditional_nodes.py);
- a body is captured on a stream of its own, one per nesting depth, and
  what it allocates comes from a memory pool of the capture's own
  (``torch.cuda.MemPool``, bound to the capturing thread while an
  outermost node is open), which no other graph's bodies use, so graphs
  may replay at the same time on different streams.  The graph keeps the
  pool: when it and every executable graph made from it are destroyed,
  :func:`release_pools` (which every eager loop runs) frees the pool.
  The loops of one graph run in the order they were captured in;
- the body is called with the step index as a 0-d int64 tensor, and the
  steps of the last block that fall past ``cap`` are made no-ops here,
  so the body never sees one.

A runtime without conditional nodes raises; nothing falls back to the
eager loop inside a capture.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils import _pytree as pytree

from . import graph_loop

#: the steps of a loop without a cap
NO_CAP = 2**63 - 1

#: nodes of the WHILE bodies captured in this process, a nested node
#: counting as one in its parent body (reports add the outer graph's own)
body_nodes = 0
#: an int64 CUDA tensor that, when set before a capture, counts every
#: launch of the captured condition kernels on the device
device_launches = None

_local = threading.local()
#: per (device index, nesting depth): the stream that captures the body
_streams: dict = {}
#: per capture id: the pool its bodies allocate from, until its graph is
#: destroyed
_pools: dict = {}


def host_read(flag) -> bool:
    """The eager loop's one read of a device flag on the host."""
    return bool(flag)


def release_pools():
    """Free the loop-body pools of the graphs that have been destroyed
    (their blocks go back to the device at the next
    ``torch.cuda.empty_cache()``, or at once where the pool's destructor
    empties it).  Every eager loop calls this; it does nothing inside a
    capture, where freeing device memory is not allowed."""
    if not _pools or torch.cuda.is_current_stream_capturing():
        return
    for cid in graph_loop.released():
        _pools.pop(cid, None)


def device_while(cond, body, carry, cap=None, block=1):
    """``while cond(carry).any(): carry = body(carry, step)`` for at most
    ``cap`` steps (no cap if None), the condition read once every
    ``block`` steps.

    ``carry`` is a pytree of tensors; ``body(carry, step)`` returns one of
    the same structure, shapes and types; ``cond(carry)`` returns a bool
    tensor.  A step that runs after every lane of the mask has cleared
    (up to ``block - 1`` of them) must leave the carry as it finds it.
    Returns ``(carry, steps)``: the steps run, a Python int when eager
    and a 0-d int64 tensor when captured."""
    if _capturing(pytree.tree_leaves(carry)[0]):
        return _captured_while(cond, body, carry, cap, block)
    release_pools()
    limit = NO_CAP if cap is None else cap
    step = 0
    while step < limit:
        if step % block == 0 and not host_read(cond(carry).any()):
            break
        carry = body(carry, step)
        step += 1
    return carry, step


def zero_steps(ref):
    """A step count of 0 for a loop over tensors like ``ref``: a Python int
    when eager, a 0-d int64 tensor inside a capture (where
    :func:`device_while` counts on the device)."""
    if _capturing(ref):
        return torch.zeros((), dtype=torch.int64, device=ref.device)
    return 0


def _capturing(ref):
    """Whether work on ``ref``'s device goes into a CUDA graph now."""
    return (ref.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _canonical(tree):
    """``tree`` with every dict's keys in sorted order, so that two carries
    of the same structure flatten alike whatever order their dicts were
    built in."""
    if isinstance(tree, dict):
        return {key: _canonical(tree[key]) for key in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_canonical(val) for val in tree)
    return tree


def _stack():
    if not hasattr(_local, "streams"):
        _local.streams = []
    return _local.streams


def _body_stream(device, depth):
    """The stream that captures bodies at ``depth`` on ``device``: not the
    capturing stream, nor one an open body holds."""
    busy = {torch.cuda.current_stream(device).cuda_stream}
    busy.update(s.cuda_stream for s in _stack())
    stream = _streams.get((device.index, depth))
    while stream is None or stream.cuda_stream in busy:
        stream = torch.cuda.Stream(device)
    _streams[(device.index, depth)] = stream
    return stream


def _capture_pool(device):
    """The pool of the capture the current stream belongs to: made at its
    first loop, kept until its graph is destroyed."""
    cid = graph_loop.capture_id(device)
    pool = _pools.get(cid)
    if pool is None:
        with torch.cuda.device(device):
            pool = _pools[cid] = torch.cuda.MemPool()
        graph_loop.retain(device)
    return pool


def _captured_while(cond, body, carry, cap, block):
    global body_nodes
    leaves, spec = pytree.tree_flatten(_canonical(carry))
    device = leaves[0].device
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    graph_loop.load()
    bufs = [t.clone(memory_format=torch.contiguous_format) for t in leaves]
    counter = torch.zeros((), dtype=torch.int64, device=device)
    offsets = torch.arange(block, dtype=torch.int64, device=device)
    bounded = cap is not None
    guard = bounded and cap % block != 0
    limit = cap if bounded else NO_CAP

    def condition(advance, handle):
        mask = cond(pytree.tree_unflatten(bufs, spec))
        graph_loop.cond(mask.contiguous(), counter, advance, limit,
                        handle, launches=device_launches)

    handle = graph_loop.handle(device)
    condition(0, handle)
    stack = _stack()
    stream = _body_stream(device, len(stack))
    pool = None if stack else _capture_pool(device)
    graph_loop.begin(device, stream, handle)
    stack.append(stream)
    try:
        with contextlib.ExitStack() as scope:
            if pool is not None:
                scope.enter_context(torch.cuda.use_mem_pool(pool, device))
            scope.enter_context(torch.cuda.stream(stream))
            steps = counter + offsets
            state = bufs
            for j in range(block):
                out, out_spec = pytree.tree_flatten(_canonical(
                    body(pytree.tree_unflatten(state, spec), steps[j])))
                if out_spec != spec:
                    raise ValueError("device_while: the body changed the "
                                     "carry's structure")
                if guard:
                    live = steps[j] < cap
                    out = [torch.where(live, new, old)
                           for new, old in zip(out, state)]
                state = out
            slot = {id(buf): j for j, buf in enumerate(bufs)}
            for j, (buf, new) in enumerate(zip(bufs, state)):
                if slot.get(id(new), j) != j:
                    raise ValueError("device_while: the body returned one "
                                     "carry entry in another's place")
                if new.shape != buf.shape or new.dtype != buf.dtype:
                    raise ValueError(
                        f"device_while: the body returned {new.dtype} "
                        f"{tuple(new.shape)} for a {buf.dtype} "
                        f"{tuple(buf.shape)} carry")
                if new is not buf:
                    buf.copy_(new)
            del state, out
            condition(block, handle)
    finally:
        stack.pop()
        body_nodes += graph_loop.end(stream)
    steps = torch.clamp(counter, max=cap) if guard else counter
    return pytree.tree_unflatten(bufs, spec), steps
