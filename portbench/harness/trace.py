"""What a traced run (``--trace 1``) reads of the device.

CUPTI, under ``torch.profiler``, records the kernels of a replayed CUDA
graph, but of a conditional WHILE node's body only the first pass: a
1,048,576-cell call of chemistry 3 ran 968 subcycles and the profile
held the network kernel of 40 of them (NVIDIA H100, torch 2.11, CUDA
12.8).  The solve's loops are such nodes, so the device's time is
taken otherwise:

- :class:`ReplayTimer` records CUDA events around each replay of a
  graph (``torch.cuda.CUDAGraph.replay``, patched for the window of a
  traced run) and around each call, on the call's stream: the replays'
  device span, the gaps between their nodes included, and the time
  before and after them in each call;
- :func:`profiled` runs a few calls under ``torch.profiler`` after the
  window and reduces the kineto events in memory to seconds by device
  operation name: what CUPTI shows of a subcycle's kernels, for the
  breakdown.  Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses

#: the kernel of the network region, as the profiler names it
NETWORK_KERNEL = "network_update_kernel"
#: entries of each list of the breakdown
TOP = 10


@dataclasses.dataclass
class Summary:
    device_ops: list  # [[name, seconds], ...], the most time first
    network_launches: int  # records of the network kernel
    device_events: int


def profiled(calls):
    """Run ``calls()`` under the profiler; returns (its result, Summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = calls()
        torch.cuda.synchronize()
    return out, summarize(prof.profiler.kineto_results.events())


def summarize(events) -> Summary:
    """Seconds by device operation name of kineto events
    (``prof.profiler.kineto_results.events()``)."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    count: dict = {}
    for ev in events:
        if ev.device_type() != DeviceType.CUDA or ev.is_user_annotation():
            continue
        name = ev.name()
        by_name[name] = by_name.get(name, 0) + ev.duration_ns()
        count[name] = count.get(name, 0) + 1
    return Summary(
        device_ops=[[k[:160], v * 1e-9] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        network_launches=sum(v for k, v in count.items()
                             if NETWORK_KERNEL in k),
        device_events=sum(count.values()))


@dataclasses.dataclass
class Spans:
    """Seconds over a window's calls, by CUDA events on the calls' stream."""

    replay_s: float  # inside the replays of graphs
    before_s: float  # from a call's start to its first replay
    after_s: float  # from a call's last replay to its end
    calls_s: float  # from each call's start to its end
    replays: int


class ReplayTimer:
    """CUDA events around every replay of a graph and every call, while
    installed (a context manager)."""

    def __init__(self):
        self.calls = []
        self._open = None

    def __enter__(self):
        import torch

        graph = torch.cuda.CUDAGraph
        self._replay = graph.replay
        timer = self

        def replay(g):
            start, end = _event(), _event()
            start.record()
            timer._replay(g)
            end.record()
            if timer._open is not None:
                timer._open[1].append((start, end))

        graph.replay = replay
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.CUDAGraph.replay = self._replay

    def call_start(self):
        self._open = [_event(), [], None]
        self._open[0].record()

    def call_end(self):
        self._open[2] = _event()
        self._open[2].record()
        self.calls.append(self._open)
        self._open = None

    def spans(self) -> Spans:
        import torch

        torch.cuda.synchronize()
        ms = {"replay": 0.0, "before": 0.0, "after": 0.0, "calls": 0.0}
        replays = 0
        for start, pairs, end in self.calls:
            ms["calls"] += start.elapsed_time(end)
            if not pairs:
                continue
            replays += len(pairs)
            ms["replay"] += sum(a.elapsed_time(b) for a, b in pairs)
            ms["before"] += start.elapsed_time(pairs[0][0])
            ms["after"] += pairs[-1][1].elapsed_time(end)
        return Spans(ms["replay"] * 1e-3, ms["before"] * 1e-3,
                     ms["after"] * 1e-3, ms["calls"] * 1e-3, replays)


def _event():
    import torch

    return torch.cuda.Event(enable_timing=True)
