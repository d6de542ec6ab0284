"""Parameter / state serialization (port of grackle_tpu/serialization.py).

The reference's dynamic string-keyed API is explicitly its serialization
hook (grackle: src/clib/dynamic_api.c:89-95): every parameter is
enumerable and settable by name.  Here the same round-trip is a dict of
plain Python values, keyed by the ``PARAMETER_REGISTRY`` names and the
unit attributes, so a file saved by either package loads in the other.
Rate tables are rebuilt deterministically from the parameters + units, so
a saved dict restores a context.  A context built from in-memory tables
(``cloudy_data``) has no file name to save: pass the same tables again on
load.
"""

from __future__ import annotations

import json

from .api import ChemistryData
from .config import PARAMETER_REGISTRY

_UNIT_KEYS = [
    "comoving_coordinates", "density_units", "length_units",
    "time_units", "a_units", "a_value",
]


def to_dict(cd: ChemistryData) -> dict:
    """All parameters + units as a JSON-serializable dict."""
    out = {"parameters": {}, "units": {}}
    for name in PARAMETER_REGISTRY:
        out["parameters"][name] = cd[name]
    for name in _UNIT_KEYS:
        out["units"][name] = getattr(cd, name)
    return out


def from_dict(state: dict, initialize: bool = True, device="cuda",
              cloudy_data=None) -> ChemistryData:
    """Rebuild a ChemistryData (and optionally its context on ``device``)
    from :func:`to_dict` output.  Tables are recomputed, not stored: they
    are a function of (parameters, units, data file or ``cloudy_data``)."""
    cd = ChemistryData()
    for name, val in state["parameters"].items():
        cd[name] = val
    for name, val in state["units"].items():
        setattr(cd, name, val)
    if initialize and cd.use_grackle:
        cd.initialize(device=device, cloudy_data=cloudy_data)
    return cd


def save(cd: ChemistryData, path: str) -> str:
    with open(path, "w") as fp:
        json.dump(to_dict(cd), fp, indent=1)
    return path


def load(path: str, initialize: bool = True, device="cuda",
         cloudy_data=None) -> ChemistryData:
    with open(path) as fp:
        return from_dict(json.load(fp), initialize=initialize,
                         device=device, cloudy_data=cloudy_data)
