"""The Python examples on the port (ports of examples/*.py).

Run one as ``python -m grackle_tpu_torch.examples.cooling_rate`` from the
root of a checkout.  Each builds its setup in an importable ``run``
function (the tests drive those in-process), reads the same environment
knobs as the JAX package's example, takes its device from
``GRACKLE_TPU_TORCH_DEVICE`` (default ``cuda``; without a card that
raises, it never falls back) and writes its ``.npz`` to the working
directory.
"""
