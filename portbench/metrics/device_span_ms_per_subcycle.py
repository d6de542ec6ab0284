"""device_span_ms_per_subcycle: the device span of the window's graph
replays (CUDA events around each torch.cuda.CUDAGraph.replay, the gaps
between a graph's nodes included) over the subcycles the window's calls
ran, ms.  CUPTI records only the first pass of a WHILE node's body, so
the profiler's kernel records cannot give the subcycle body's time
(portbench/harness/trace.py)."""


def read(run):
    spans = run.spans
    subcycles = sum(c.subcycles for c in run.calls)
    if spans is None or spans.replay_s <= 0 or subcycles <= 0:
        return None
    return spans.replay_s / subcycles * 1e3
