"""One run of one cell: set-up, the measured window, an optional profiled
slice, the check against the reference, and the result line.

The window drives ``ChemistryData.solve_chemistry`` of grackle_tpu_torch
as a hydro code whose arrays live on the host does: each call hands the
state over as numpy arrays, the port copies them in and replays its
graph (graph_cache.run), and every returned field comes back to numpy.
The loop is closed: a call starts when the previous one has returned.
The window starts after set-up and ends at the end of the first call
that ends after ``seconds``.

Set-up runs from the process's start to the window's start: importing
torch and the port, loading its two kernels from its build directory in
the checkout (grackle_tpu_torch/_build/, built there at a checkout's
first run), ``initialize``, drawing the state pool from the seed, and
the key's two warm-up calls, eager then capturing, at the cell's width
and fields and a short ``dt``: the graph does not depend on ``dt``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import sys
import time

import numpy as np

from . import correct
from .trace import ReplayTimer

#: top-level module names no run may hold: JAX, its relatives, the JAX
#: package and the repository modules that import it
FORBIDDEN = ("jax", "jaxlib", "flax", "grackle_tpu", "__graft_entry__",
             "bench", "chip_smoke")


@dataclasses.dataclass
class Call:
    wall_s: float
    cells: int
    subcycles: int
    outputs_s: float


@dataclasses.dataclass
class Run:
    """What the metric readers read (portbench/metrics/*.py)."""

    cell: object
    on_card: bool
    setup_s: float
    window_s: float
    calls: list
    graph_calls: dict  # kinds of the window's calls: eager, capture, replay
    reserved_max_bytes: int  # torch.cuda.memory_reserved, the most read
    spans: object = None  # trace.Spans of the window, in a traced run
    profile: object = None  # trace.Summary of the profiled calls after it


def process_start() -> float:
    """``time.perf_counter()`` at this process's start (from /proc; now,
    where that cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            after = fh.read().rsplit(")", 1)[1].split()
        started = int(after[19]) / os.sysconf("SC_CLK_TCK")
        return now - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


class Program:
    """The port's stateful context for a cell, and its calls."""

    def __init__(self, cell, groups, device, parameters=None):
        from grackle_tpu_torch.api import ChemistryData

        cd = ChemistryData()
        for key, val in dict(cell.config["parameters"],
                             **(parameters or {})).items():
            setattr(cd, key, val)
        for key, val in cell.config["units"].items():
            setattr(cd, key, val)
        cd.initialize(device=device, cloudy_data=groups)
        self.cd = cd
        self.on_card = str(device).startswith("cuda")
        self.reserved_max = 0
        #: a trace.ReplayTimer that times each call, in a traced run
        self.timer = None

    def graph_calls(self) -> dict:
        return dict(self.cd.context.graphs.calls)

    def call(self, state, a_value, dt):
        """One call, numpy in to numpy out: (outputs, Call)."""
        import torch

        cd = self.cd
        cd.a_value = a_value
        t0 = time.perf_counter()
        if self.timer is not None:
            self.timer.call_start()
        new_f, diag = cd.solve_chemistry(dict(state), dt)
        t1 = time.perf_counter()
        out = {key: val.cpu().numpy() for key, val in new_f.items()}
        if self.timer is not None:
            self.timer.call_end()
        if self.on_card:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        if self.on_card:
            self.reserved_max = max(self.reserved_max,
                                    torch.cuda.memory_reserved())
        return out, Call(t2 - t0, len(state["density"]),
                         int(diag["subcycles"]), t2 - t1)


def _traffic(cell, overrides):
    traffic = dict(cell.traffic)
    traffic.update(overrides or {})
    return traffic


def make_pool(cell, traffic, seed):
    from portbench.reference.units import CodeUnits

    rng = np.random.default_rng(seed)
    return cell.recipe.states(traffic, cell.config["parameters"],
                              CodeUnits(**cell.config["units"]), rng)


def make_groups(cell):
    from portbench.yardstick.synthetic import synthetic_cloudy_groups

    return synthetic_cloudy_groups(**cell.config["tables"])


def a_value_of(traffic, i):
    sched = traffic["a_value"]
    return float(sched["start"]) + i * float(sched["step"])


def warm_up(program, pool, traffic):
    """The key's eager and capturing calls at a short dt."""
    for _ in range(2):
        program.call(pool[0], a_value_of(traffic, 0),
                     float(traffic["warmup_dt"]))


def window(program, pool, traffic, seconds, sample):
    """Calls until one ends after ``seconds``: (calls, failed, window
    seconds, the next call's index).  Each call is offered to ``sample``
    as (state, a_value, outputs)."""
    dt = float(traffic["dt"])
    calls, failed = [], 0
    i = 0
    start = time.perf_counter()
    while True:
        state, a_value = pool[i % len(pool)], a_value_of(traffic, i)
        try:
            out, rec = program.call(state, a_value, dt)
        except RuntimeError as exc:  # a call that fails is counted
            failed += 1
            print(f"portbench: call {i} failed: {exc}", file=sys.stderr)
        else:
            calls.append(rec)
            sample.offer((state, a_value, out))
        i += 1
        if time.perf_counter() - start >= seconds:
            return calls, failed, time.perf_counter() - start, i


def profiled_calls(program, pool, traffic, first):
    """The traffic's ``trace.calls`` calls from ``first`` under the
    profiler: a trace.Summary."""
    from . import trace

    dt = float(traffic["dt"])
    count = int(traffic["trace"]["calls"])

    def calls():
        for j in range(first, first + count):
            program.call(pool[j % len(pool)], a_value_of(traffic, j), dt)

    return trace.profiled(calls)[1]


def check(cell, groups, sample, traffic, device):
    """{name: (value, limit)} of the numbers compared; where they are."""
    limit = float(cell.config["checks"]["max_rel_err"])
    if not sample.kept:
        return {"max_rel_err": (float("inf"), limit)}, "no call to check"
    answers = correct.reference_answers(
        cell.config, groups, sample.kept, float(traffic["dt"]),
        int(traffic["check"]["rows"]), device)
    worst, where = 0.0, "no cell (every field equal)"
    for (_, _, got), want in zip(sample.kept, answers):
        err, at = correct.max_rel_err(got, want)
        if err > worst:
            worst, where = err, at
    return {"max_rel_err": (worst, limit)}, (
        f"{len(sample.kept)} calls of {sample.seen} checked; the largest "
        f"error at {where}")


def _device_record(on_card, peak, record):
    import torch

    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": int(peak)}
    if record.spans is not None:
        device["busy_s"] = record.spans.replay_s
        device["window_s"] = record.window_s
    return device


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", traffic_overrides=None,
        program_parameters=None):
    """One run of ``cell``: (the result line's object, a note on what was
    checked).  The numbers compared come last in it, under ``checks``.  On a
    device other than the card (the CPU rehearsal of the tests) it reads
    no device metric."""
    import torch

    traffic = _traffic(cell, traffic_overrides)
    groups = make_groups(cell)
    program = Program(cell, groups, device, program_parameters)
    pool = make_pool(cell, traffic, seed)
    warm_up(program, pool, traffic)
    on_card = program.on_card
    if on_card:
        torch.cuda.synchronize()
        program.reserved_max = torch.cuda.memory_reserved()
    before = program.graph_calls()
    setup_s = time.perf_counter() - t_start

    sample = correct.Sample(int(traffic["check"]["calls"]),
                            np.random.default_rng([seed, 1]))
    timed = trace and on_card
    with (ReplayTimer() if timed else contextlib.nullcontext()) as timer:
        program.timer = timer
        calls, failed, window_s, nxt = window(program, pool, traffic,
                                              seconds, sample)
        program.timer = None
    after = program.graph_calls()
    kinds = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("eager", "capture", "replay")}
    record = Run(cell=cell, on_card=on_card, setup_s=setup_s,
                 window_s=window_s, calls=calls, graph_calls=kinds,
                 reserved_max_bytes=program.reserved_max)
    if timed:
        record.spans = timer.spans()
        record.profile = profiled_calls(program, pool, traffic, nxt)
    peak = 0
    if on_card:
        peak = max(program.reserved_max, torch.cuda.max_memory_reserved())

    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = metric.reader.read(record)
        if value is not None:
            metrics[metric.name] = {"value": value, "unit": metric.unit}

    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, note = check(cell, groups, sample, traffic, device)
    note += f" (the check took {time.perf_counter() - t_check:.1f} s)"
    if record.profile is not None:
        note += (f"; {record.spans.replays} replays timed; the profiled "
                 f"calls hold {record.profile.device_events} device "
                 f"records, {record.profile.network_launches} of them "
                 f"network launches")
    result = {
        "correct": failed == 0 and all(v <= lim
                                       for v, lim in checks.values()),
        "attempted": len(calls) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": _device_record(on_card, peak, record),
    }
    if record.profile is not None:
        spans = record.spans
        result["breakdown"] = {
            "device_ops": record.profile.device_ops,
            "idle_gaps": sorted([
                ["outside replays, before: numpy in, scalar block, copy-in",
                 spans.before_s],
                ["outside replays, after: clone-out, numpy out",
                 spans.after_s],
                ["between calls: the benchmark's loop",
                 max(0.0, window_s - spans.calls_s)]],
                key=lambda gap: -gap[1])}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result, note
