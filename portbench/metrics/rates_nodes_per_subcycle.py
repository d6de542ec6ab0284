"""rates_nodes_per_subcycle: the graph nodes that the rate lookup and the
H2-equilibrium limit (ops/chemistry_step.lookup_cool_rates and
h2_equilibrium_limit, one launch of csrc/rate_lookup.cu on
the card) add to one captured subcycle body, counted at capture from the
capturing graph's node count: the port's ``rates_nodes`` counter in
grackle_tpu_torch/tracing.py.  None off the card, and where the port has
no such counter or nothing was captured."""


def read(run):
    if not run.on_card:
        return None
    try:
        from grackle_tpu_torch import tracing
    except ImportError:
        return None
    count = getattr(tracing, "rates_nodes_per_subcycle", None)
    return None if count is None else count()
