"""run.py itself: it measures only on a CUDA device, and a whole run on
the card gives a correct result line (marked ``card``)."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import spec

RUN = os.path.join(spec.HERE, "run.py")


def _run(*args, timeout=900):
    return subprocess.run([sys.executable, RUN, *args], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _run("--workload", "tabulated_uvb.one_cell", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_run_on_the_card(card, trace):
    out = _run("--workload", "tabulated_uvb.one_cell", "--seed",
               str(2**31 + 21), "--seconds", "2", "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    if trace == "1":
        assert result["metrics"]["replay_share"]["value"] == 1.0
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    else:
        assert result["metrics"]["cells_per_s"]["value"] > 0
