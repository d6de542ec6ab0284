"""The benchmark's plain reference: the port's plain PyTorch solve path,
frozen.

A copy of grackle_tpu_torch's modules at commit 4d9fd799c427 (config,
units, constants, rates/, data/cloudy and data/uvb, ops/ but the CUDA
routes), with four changes: the network region always runs the plain
twin (ops/network.py), the loops always run eagerly (ops/device_loop.py
keeps the eager path alone), the solve is the monolithic one (the
compacted solve is left out) and tables come from memory only (no file
reader).  It imports nothing of grackle_tpu_torch, grackle_tpu or jax;
:mod:`.solve` is its entry.  Frozen: later changes add files beside it.
"""
