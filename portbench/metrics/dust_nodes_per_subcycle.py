"""dust_nodes_per_subcycle: the graph nodes that the equilibrium dust
temperature of ops/cooling.cool1d_multi adds to one captured subcycle
body, counted at capture from the capturing graph's node count: the
port's ``dust_nodes`` counter in grackle_tpu_torch/tracing.py.  None off
the card, and where the port has no such counter or nothing was
captured."""


def read(run):
    if not run.on_card:
        return None
    try:
        from grackle_tpu_torch import tracing
    except ImportError:
        return None
    count = getattr(tracing, "dust_nodes_per_subcycle", None)
    return None if count is None else count()
