"""Version plumbing (port of grackle_tpu/version.py).

Analogue of the reference's auto-generated version embedding
(grackle: src/clib/Make.config.targets auto_get_version.c,
grackle.h:185 get_grackle_version): the version plus the git branch and
revision of the checkout, or "N/A" for each where there is no git or no
repository (an unpacked ``git archive``).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess

VERSION = "0.1.0"


@dataclasses.dataclass(frozen=True)
class GrackleVersion:
    version: str
    branch: str
    revision: str


def _git(args):
    try:
        out = subprocess.run(
            ["git"] + args,
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except (OSError, subprocess.SubprocessError):
        return "N/A"
    return out.stdout.strip() if out.returncode == 0 else "N/A"


def get_grackle_version() -> GrackleVersion:
    return GrackleVersion(
        version=VERSION,
        branch=_git(["rev-parse", "--abbrev-ref", "HEAD"]),
        revision=_git(["rev-parse", "HEAD"]),
    )
