"""scalars_ms_per_call: the host time of a stateful call's scalar work
(the unit scalars, the UVB photo rates at the call's redshift and the
scalar block's copy: the port's ``call_scalars`` span in
grackle_tpu_torch/tracing.py), the median of the calls the span keeps,
so that the key's eager and capturing warm-up calls do not weigh, ms.
None off the card, and where the port has no such span or it holds
nothing."""


def read(run):
    if not run.on_card:
        return None
    try:
        from grackle_tpu_torch import tracing
    except ImportError:
        return None
    median = tracing.call_scalars.median()
    return None if median is None else median * 1e3
