"""A traced run of ``chem2_uvb_shield.grid1m_z3`` on the card reads the
port's shielding counter and scalar span (marked ``card``)."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import spec

RUN = os.path.join(spec.HERE, "run.py")


@pytest.mark.card
def test_traced_run_reads_the_shielding(card):
    out = subprocess.run(
        [sys.executable, RUN, "--workload", "chem2_uvb_shield.grid1m_z3",
         "--seed", str(2**31 + 23), "--seconds", "2", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    metrics = result["metrics"]
    assert metrics["replay_share"]["value"] == 1.0
    assert metrics["shield_nodes_per_subcycle"]["value"] > 0
    assert metrics["scalars_ms_per_call"]["value"] > 0
