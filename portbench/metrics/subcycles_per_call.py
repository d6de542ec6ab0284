"""subcycles_per_call: the subcycles a call ran (its network launches,
diag["subcycles"] of solve_chemistry, summed over the compacted path's
warm tiles and batches), mean over the window's calls."""


def read(run):
    if not run.calls:
        return None
    return sum(c.subcycles for c in run.calls) / len(run.calls)
