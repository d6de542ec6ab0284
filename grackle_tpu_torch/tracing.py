"""The port's own spans and counters, process-wide, cheap enough to stay
on in every run (as ``ops/device_loop.body_nodes`` and the kernels'
launch counts, ``ops/kernel_lib.Library``, are).

- :data:`call_scalars`: a host span, the seconds a stateful call
  (``api.solve_chemistry``) spends on its scalar work: the unit scalars,
  the UVB photo rates at the call's redshift and the scalar block's copy
  to the device (``api.call_scalars``).  Two clock reads a call; the
  latest :data:`RECORD_CALLS` calls are kept.
- :data:`shield_nodes`: by shielding block, the nodes the block added to
  the CUDA graph being captured, at its latest capture: the Rahmati et
  al. 2013 factors and shielded rates (``"rahmati"``) and the H2 factor
  (``"h2"``) of ``ops/chemistry_step.lookup_cool_rates``, and the
  shielded photo-heating of ``ops/cooling.cool1d_multi``
  (``"photo_heating"``).  Each is read from the capturing graph's own
  node count before and after the block (ops/graph_loop.capture_nodes),
  so it costs nothing at replay and nothing on an eager call.  A
  subcycle body runs each block once, so their sum is the shielding's
  nodes a subcycle (:func:`shield_nodes_per_subcycle`).  On the card the
  rate lookup is one launch of csrc/rate_lookup.cu, which runs neither
  ``"rahmati"`` nor ``"h2"`` (their blocks are in its CPU twin), so
  there the sum is the photo-heating block's alone.
- :data:`dust_nodes`: likewise, the nodes the equilibrium dust
  temperature of ``ops/cooling.cool1d_multi`` added to the graph being
  captured, at its latest capture (None before any): one launch of
  csrc/dust_temp.cu on the card (:func:`dust_nodes_per_subcycle`).
- :data:`rates_nodes`: likewise, the nodes that the rate lookup and the
  H2-equilibrium limit (``ops/rates_kernel.rate_lookup`` in
  ``ops/solver.subcycle``) added to the graph being captured, at its
  latest capture (None before any): one launch of csrc/rate_lookup.cu on
  the card (:func:`rates_nodes_per_subcycle`).
"""

from __future__ import annotations

import collections
import contextlib
import statistics

import torch

from .ops import graph_loop

#: calls a span keeps
RECORD_CALLS = 4096


class Span:
    """A bounded record of seconds, one entry a call."""

    def __init__(self, size: int = RECORD_CALLS):
        self.record = collections.deque(maxlen=size)

    def add(self, seconds: float):
        self.record.append(seconds)

    def median(self):
        """The median of the record (so a few outliers, such as a key's
        eager and capturing calls, do not weigh); None when empty."""
        return statistics.median(self.record) if self.record else None


call_scalars = Span()
shield_nodes: dict = {}
dust_nodes = None
rates_nodes = None


@contextlib.contextmanager
def _nodes_added(ref: torch.Tensor, store):
    """Count the nodes that the work inside adds to the graph the current
    stream of ``ref``'s device is capturing, and pass the count to
    ``store``; nothing where that stream is not capturing."""
    if ref.device.type != "cuda" or \
            not torch.cuda.is_current_stream_capturing():
        yield
        return
    before = graph_loop.capture_nodes(ref.device)
    yield
    store(graph_loop.capture_nodes(ref.device) - before)


def shield_block(name: str, ref: torch.Tensor):
    """Count the nodes of the shielding block ``name`` into
    ``shield_nodes[name]`` (see :func:`_nodes_added`)."""
    return _nodes_added(ref, lambda n: shield_nodes.__setitem__(name, n))


def dust_block(ref: torch.Tensor):
    """Count the nodes of the dust temperature solve of
    ``ops/cooling.cool1d_multi`` into ``dust_nodes`` (see
    :func:`_nodes_added`)."""
    def store(n):
        global dust_nodes
        dust_nodes = n

    return _nodes_added(ref, store)


def rates_block(ref: torch.Tensor):
    """Count the nodes of the rate lookup and the H2-equilibrium limit of
    ``ops/solver.subcycle`` into ``rates_nodes`` (see
    :func:`_nodes_added`)."""
    def store(n):
        global rates_nodes
        rates_nodes = n

    return _nodes_added(ref, store)


def shield_nodes_per_subcycle():
    """The shielding's nodes in one captured subcycle body (the sum over
    its blocks at their latest capture); None before any capture."""
    return sum(shield_nodes.values()) if shield_nodes else None


def dust_nodes_per_subcycle():
    """The dust temperature's nodes in one captured subcycle body, at its
    latest capture; None before any capture."""
    return dust_nodes


def rates_nodes_per_subcycle():
    """The rate lookup's and the H2-equilibrium limit's nodes in one
    captured subcycle body, at its latest capture; None before any
    capture."""
    return rates_nodes
