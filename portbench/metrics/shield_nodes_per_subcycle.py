"""shield_nodes_per_subcycle: the graph nodes that the shielding adds to
one captured subcycle body (the Rahmati et al. 2013 factors and shielded
rates and the H2 factor of ops/chemistry_step.lookup_cool_rates, the
shielded photo-heating of ops/cooling.cool1d_multi), counted at capture
from the capturing graph's node count: the port's ``shield_nodes``
counter in grackle_tpu_torch/tracing.py.  None off the card, and where
the port has no such counter or nothing was captured."""


def read(run):
    if not run.on_card:
        return None
    try:
        from grackle_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.shield_nodes_per_subcycle()
