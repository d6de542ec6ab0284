"""Per-shard independent solves over a list of devices (port of
grackle_tpu/parallel/sharding.py).

The reference has no distributed backend: host MPI ranks each call the
re-entrant ``local_*`` API on their own subgrid, and OpenMP threads split
grid rows (grackle: src/clib/initialize_chemistry_data.c:107-120,
solve_rate_cool_g.F:369-403).  Cells are fully independent, so the flat
cell axis is cut into one contiguous shard per entry of the mesh (a list
of ``torch.device``s; an entry may repeat, so ``["cuda:0"] * 4`` runs four
shards on one card).  Each shard goes through ``api.solve_prepared`` at
its own width on its own device: the solve path, the compaction batch and
the subcycle loop are picked per shard, so a shard whose cells converge
early retires on its own.  There is no collective inside the solve; a
shard on another device than the context's gets the context's tables
copied to that device.

The only spatially-coupled computation (H2 self-shielding option 1's
6-point density stencil, solve_rate_cool_g.F:1420-1434) is taken by the
caller on the unsharded grid and passed as ``l_h2shield_field``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import api as _api
from ..graph_cache import GraphCache
from ..ops.common import make_unit_scalars


def make_cell_mesh(devices=None):
    """The devices the cell axis is cut over: every visible CUDA device
    unless ``devices`` names others.  Raises, as ``api.resolve_device``
    does, when a CUDA device is asked for and there is none."""
    if devices is None:
        _api.resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [_api.resolve_device(d) for d in devices]


def pad_to_multiple(fields, multiple: int):
    """Pad every field to a multiple of ``multiple`` cells so the cell
    axis cuts into equal shards; returns (padded_fields, original_n).

    Padding cells are copies of cell 0, so the solver treats them like
    real cells; they are sliced away on return.
    """
    n = None
    out = {}
    for key, val in fields.items():
        n = val.shape[0]
        pad = (-n) % multiple
        out[key] = torch.cat([val, val[:1].expand((pad,) + val.shape[1:])]) \
            if pad else val
    return out, n


def shard_fields(fields, mesh):
    """The cell axis of every field cut into ``len(mesh)`` equal pieces,
    piece i on ``mesh[i]``: one dict of fields per entry of the mesh
    (the counterpart of placing the fields with a ``NamedSharding`` over
    the cell axis).  Raises ValueError, as ``jax.device_put`` does, when
    the cell count is not a multiple of ``len(mesh)``."""
    n_shards = len(mesh)
    out = [{} for _ in mesh]
    for key, val in fields.items():
        n = val.shape[0]
        if n % n_shards:
            raise ValueError(f"field {key!r} of {n} cells does not cut "
                             f"into {n_shards} equal shards")
        width = n // n_shards
        for i, device in enumerate(mesh):
            out[i][key] = val[i * width:(i + 1) * width].to(device)
    return out


def _same_device(a: torch.device, b: torch.device) -> bool:
    def index(d):
        if d.index is not None or d.type != "cuda":
            return d.index
        return torch.cuda.current_device()

    return a.type == b.type and index(a) == index(b)


def _on_device(obj, device):
    """``obj`` with every tensor it holds (through dataclasses) on
    ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _on_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def context_on(ctx, device):
    """The context with its tables on ``device`` (itself when they are
    already there)."""
    if _same_device(torch.device(ctx.device), device):
        return ctx
    return dataclasses.replace(
        ctx, tables=_on_device(ctx.tables, device),
        cloudy_primordial=_on_device(ctx.cloudy_primordial, device),
        cloudy_metal=_on_device(ctx.cloudy_metal, device), device=device,
        graphs=GraphCache())


def solve_chemistry_sharded(ctx, fields, dt, mesh, grid_dx: float = 0.0,
                            l_h2shield_field=None):
    """solve_chemistry with one independent solve per shard.

    fields: dict of flat [N] arrays or tensors; N is padded to a multiple
    of ``len(mesh)`` with copies of cell 0.  Returns (new_fields on the
    context's device, diagnostics) with the original N: ``n_iterations``
    [n_shards] (each shard's subcycle count), ``converged`` and
    ``cell_iterations`` [N], and per shard the ``subcycles`` run (its
    network launches) and the compacted solve's ``trips``.
    """
    cfg = ctx.config
    f, imetal = _api._prep_fields(ctx, fields)
    if l_h2shield_field is not None:
        # cut with the fields, taken out of each shard's again
        f = dict(f, l_h2shield_field=_api.shield_length_tensor(
            ctx, l_h2shield_field))
    f, n_orig = pad_to_multiple(f, len(mesh))
    us = make_unit_scalars(cfg, ctx.tables, ctx.units, grid_dx)

    contexts, blocks = {}, {}
    outs, diags = [], []
    for i, (device, f_local) in enumerate(zip(mesh, shard_fields(f, mesh))):
        device = torch.device(device)
        key = str(device)
        if key not in contexts:
            contexts[key] = context_on(ctx, device)
            # the call's scalars, one block a device
            blocks[key] = _api.call_scalars(ctx, device, us)
        l_local = f_local.pop("l_h2shield_field", None)
        new_f, diag = _api.solve_cached(
            contexts[key], blocks[key], f_local, float(dt), imetal,
            l_local, graphs=ctx.graphs, part=("shard", i, len(mesh)))
        outs.append(new_f)
        diags.append(diag)

    home = torch.device(ctx.device)

    def gather(parts):
        return torch.cat([p.to(home) for p in parts])[:n_orig]

    new_f = {k: gather([o[k] for o in outs]) for k in outs[0]}
    diagnostics = {
        "n_iterations": torch.tensor(
            [int(d["n_iterations"]) for d in diags], dtype=torch.int32,
            device=home),
        "converged": gather([d["converged"] for d in diags]),
        "cell_iterations": gather([d["cell_iterations"] for d in diags]),
        "subcycles": [int(d["subcycles"]) for d in diags],
        "trips": [int(d["trips"]) for d in diags],
    }
    return new_f, diagnostics
