"""Whether the timed path's answers are right: a sample of the window's
calls against the plain reference (portbench/reference).

The sample is drawn from the seed over every call the window made
(reservoir sampling, so it is fixed by the seed and the number of
calls).  Each sampled call keeps its input state, its ``a_value`` and
every field ``solve_chemistry`` handed back.  Once the window has closed
and the program's state is freed, the reference solves the same states:
calls at one ``a_value`` together, their cells side by side (every cell
of these configurations is independent of the others), in blocks of
``rows`` cells.

The number compared is ``max_rel_err``: the largest |program - reference|
/ |reference| over every returned field and cell of the sample (a value
the program returns as nan or inf counts as infinitely far).
"""

from __future__ import annotations

import numpy as np


class Sample:
    """A reservoir of ``size`` calls, drawn with ``rng``."""

    def __init__(self, size: int, rng):
        self.size = size
        self.rng = rng
        self.seen = 0
        self.kept = []

    def offer(self, item):
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


def reference_answers(config: dict, groups: dict, kept: list, dt: float,
                      rows: int, device) -> list:
    """The reference's fields for each kept ``(state, a_value, outputs)``
    advanced by ``dt``, in order."""
    from portbench.reference import solve as ref

    ctx = ref.context(config["parameters"], config["units"], groups, device)
    answers = [None] * len(kept)
    by_a: dict = {}
    for j, (_, a_value, _) in enumerate(kept):
        by_a.setdefault(a_value, []).append(j)
    for a_value, idx in sorted(by_a.items()):
        at = ref.at_a_value(ctx, a_value)
        states = [kept[j][0] for j in idx]
        names = list(states[0])
        joined = {k: np.concatenate([s[k] for s in states]) for k in names}
        total = len(joined["density"])
        parts = []
        for lo in range(0, total, rows):
            parts.append(ref.solve(
                at, {k: v[lo:lo + rows] for k, v in joined.items()}, dt))
        whole = {k: np.concatenate([p[k] for p in parts]) for k in names}
        lo = 0
        for j, state in zip(idx, states):
            n = len(state["density"])
            answers[j] = {k: v[lo:lo + n] for k, v in whole.items()}
            lo += n
    return answers


def max_rel_err(got: dict, want: dict):
    """(largest relative error, the field and cell where it is)."""
    worst, where = 0.0, None
    for name, ref in want.items():
        if name not in got:
            return float("inf"), f"{name} not returned"
        val = np.asarray(got[name], dtype=np.float64)
        ref = np.asarray(ref, dtype=np.float64)
        if val.shape != ref.shape:
            return float("inf"), f"{name} shape {val.shape} != {ref.shape}"
        with np.errstate(divide="ignore", invalid="ignore"):
            err = np.abs(val - ref) / np.abs(ref)
        err = np.where(val == ref, 0.0, err)
        err = np.where(np.isfinite(val), err, np.inf)
        err = np.nan_to_num(err, nan=np.inf)
        i = int(np.argmax(err))
        if err[i] > worst:
            worst, where = float(err[i]), f"{name}[{i}]"
    return worst, where
