"""The solve's data-dependent loops, run eagerly on the host.

This copy keeps only the eager path of the port's ``device_while``: the
exit condition is read on the host once every ``block`` steps.  The
port's CUDA-graph capture of the same loop (conditional WHILE nodes) is
the program under test and is not copied.
"""

from __future__ import annotations

#: the steps of a loop without a cap
NO_CAP = 2**63 - 1


def host_read(flag) -> bool:
    """The loop's one read of a device flag on the host."""
    return bool(flag)


def device_while(cond, body, carry, cap=None, block=1):
    """``while cond(carry).any(): carry = body(carry, step)`` for at most
    ``cap`` steps (no cap if None), the condition read once every
    ``block`` steps.  A step that runs after every lane of the mask has
    cleared must leave the carry as it finds it.  Returns ``(carry,
    steps)``, the steps run as a Python int."""
    limit = NO_CAP if cap is None else cap
    step = 0
    while step < limit:
        if step % block == 0 and not host_read(cond(carry).any()):
            break
        carry = body(carry, step)
        step += 1
    return carry, step
