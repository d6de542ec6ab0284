"""outputs_ms_per_call: the benchmark's own span around bringing a call's
returned fields to numpy (after solve_chemistry returned), mean a call
of the window, ms."""


def read(run):
    if not run.calls:
        return None
    return sum(c.outputs_s for c in run.calls) / len(run.calls) * 1e3
