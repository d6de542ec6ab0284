"""The port's Python examples (grackle_tpu_torch/examples/) against the
stored example answers, in-process on the CPU.

tests/test_python_examples.py runs the JAX package's examples as
subprocesses and holds every array they write to
tests/answers/examples/*.npz at rtol 1e-6.  Here each example's ``run``
is driven in-process with ``device="cpu"`` and the synthetic tables built
in memory, against the same answers and the same sanity checks:
cooling_rate in full for chemistry 0 to 3; cooling_cell and both
freefall cases over a stated prefix of their stored trajectories (each is
deterministic, so a shorter FINAL_TIME or a lower final density gives a
prefix of the full run).  A one-cell step of the port costs the CPU about
0.1 s of op dispatch, so the longer trajectories are held on the card:
both freefall runs in full (748 and 414 steps) and cooling_cell's first
500 steps by chip_smoke.py phase 4h, and cooling_cell's whole 28,443
steps by ``python3 chip_smoke.py --cooling-cell-full``, a card run of
its own (about 1,000 s); cooling_rate with chemistry 2 and 3 (about
20 s each) and the full freefall runs are marked slow here.  The functional_jit example is held by
tests/test_torch_functional.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu_torch.data.synthetic import synthetic_cloudy_groups
from grackle_tpu_torch.examples import (
    common,
    cooling_cell,
    cooling_rate,
    freefall,
    yt_grackle,
)
from grackle_tpu_torch.utilities.physical_constants import sec_per_Myr
from tests.test_python_examples import ANSWER_DIR

torch.set_num_threads(1)

RTOL = 1e-6
#: steps of the stored cooling_cell and freefall trajectories held here
PREFIX = {"cooling_cell": 24, "freefall_metal0": 32, "freefall_metal1": 32}


@pytest.fixture(scope="module")
def tables():
    return synthetic_cloudy_groups()


def _stored(tag):
    return np.load(os.path.join(ANSWER_DIR, tag + ".npz"))


def _check(tag, out, steps=None):
    """Every stored array at rtol 1e-6, or its first ``steps`` records."""
    stored = _stored(tag)
    assert sorted(out) == sorted(stored.files), tag
    for key in stored.files:
        want = stored[key] if steps is None else stored[key][:steps]
        assert out[key].shape == want.shape, f"{tag}/{key}"
        np.testing.assert_allclose(out[key], want, rtol=RTOL, atol=0,
                                   err_msg=f"{tag}/{key}")


def _cooling_rate_sane(out):
    """tests/test_python_examples.py's band: equilibrium cooling at 1e6
    to 1e7 K within 1e-26 to 1e-20 erg cm^3 / s."""
    T, rate = out["temperature"], out["cooling_rate"]
    assert T.shape == rate.shape and np.all(np.isfinite(rate))
    sel = (T > 1e6) & (T < 1e7)
    assert np.all(np.abs(rate[sel]) > 1e-26)
    assert np.all(np.abs(rate[sel]) < 1e-20)


@pytest.mark.parametrize("chem", [
    0, 1,
    pytest.param(2, marks=pytest.mark.slow),
    pytest.param(3, marks=pytest.mark.slow),
])
def test_cooling_rate_example(tables, chem):
    out = cooling_rate.run(chem, device="cpu", cloudy_data=tables,
                           verbose=False)
    _check(f"cooling_rate_chem{chem}", out)
    _cooling_rate_sane(out)


def test_cooling_rate_main_writes_npz(tmp_path, monkeypatch):
    """The example as a program: PRIMORDIAL_CHEM and the device from the
    environment, the tables from the synthetic data file get_data_file
    writes, cooling_rate.npz in the working directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PRIMORDIAL_CHEM", "0")
    monkeypatch.setenv("GRACKLE_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("GRACKLE_DATA_FILE", raising=False)
    monkeypatch.setattr(common, "SYNTHETIC_FILE",
                        str(tmp_path / ".synthetic_cloudy.h5"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cooling_rate.main()
    with np.load(tmp_path / "cooling_rate.npz") as out:
        _check("cooling_rate_chem0", dict(out))


def test_cooling_cell_example_prefix(tables):
    """The first PREFIX steps: the run's dt is fixed at its start, so a
    FINAL_TIME between two stored times stops after those steps."""
    stored = _stored("cooling_cell")
    steps = PREFIX["cooling_cell"]
    dt = stored["time"][1] / sec_per_Myr
    out = cooling_cell.run((steps - 0.5) * dt, device="cpu",
                           cloudy_data=tables, verbose=False)
    _check("cooling_cell", out, steps)
    # with radiative cooling on, the cell cools over the run
    assert out["temperature"][-1] < out["temperature"][0]


def _freefall(metal, steps, tables):
    """The collapse up to a density between the stored records
    ``steps - 1`` and ``steps``: the first ``steps`` records (density
    rises every step); the full run when ``steps`` is None."""
    tag = f"freefall_metal{metal}"
    final = freefall.FINAL_DENSITY
    if steps:
        final = float(np.sqrt(np.prod(_stored(tag)["density"][
            steps - 1:steps + 1])))
    out = freefall.run(metal, final_density=final, device="cpu",
                       cloudy_data=tables if metal else None, verbose=False)
    _check(tag, out, steps)
    assert np.all(np.isfinite(out["temperature"]))
    return out


@pytest.mark.parametrize("metal", [0, 1])
def test_freefall_example_prefix(tables, metal):
    _freefall(metal, PREFIX[f"freefall_metal{metal}"], tables)


@pytest.mark.slow
@pytest.mark.parametrize("metal", [0, 1])
def test_freefall_example_full(tables, metal):
    out = _freefall(metal, None, tables)
    # density rises by orders of magnitude in the collapse
    assert out["density"][-1] > 1e3 * out["density"][0]


def test_device_and_tables_from_the_environment(monkeypatch, tmp_path):
    """GRACKLE_TPU_TORCH_DEVICE defaults to cuda (which raises without a
    card, never falling back); GRACKLE_DATA_FILE names a file to read,
    else the synthetic data file is written and read."""
    synthetic = tmp_path / "examples" / ".synthetic_cloudy.h5"
    synthetic.parent.mkdir()
    monkeypatch.setattr(common, "SYNTHETIC_FILE", str(synthetic))
    monkeypatch.delenv("GRACKLE_TPU_TORCH_DEVICE", raising=False)
    assert common.get_device() == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            cooling_rate.run(0, verbose=False)
    monkeypatch.setenv("GRACKLE_DATA_FILE", str(tmp_path / "missing.h5"))
    assert common.get_data_file() == str(synthetic)
    path = tmp_path / "tables.h5"
    path.write_bytes(b"")
    monkeypatch.setenv("GRACKLE_DATA_FILE", str(path))
    assert common.get_data_file() == str(path)


def test_get_data_file_writes_once(monkeypatch, tmp_path):
    """Without GRACKLE_DATA_FILE, get_data_file writes the synthetic file
    (the content of the tables in memory, read back by data/h5read.py)
    the first time, leaves nothing else beside it, and returns the
    existing file after that without writing it again."""
    monkeypatch.delenv("GRACKLE_DATA_FILE", raising=False)
    synthetic = tmp_path / ".synthetic_cloudy.h5"
    monkeypatch.setattr(common, "SYNTHETIC_FILE", str(synthetic))
    assert common.get_data_file() == str(synthetic)
    assert os.listdir(tmp_path) == [".synthetic_cloudy.h5"]
    assert chip_smoke.file_vs_groups(str(synthetic),
                                     synthetic_cloudy_groups()) == 49
    synthetic.write_bytes(b"not rewritten")
    assert common.get_data_file() == str(synthetic)
    assert synthetic.read_bytes() == b"not rewritten"


def test_existing_data_file_wins(monkeypatch, tmp_path):
    """An existing GRACKLE_DATA_FILE is returned, and no synthetic file is
    written."""
    path = tmp_path / "CloudyData_UVB=HM2012.h5"
    path.write_bytes(b"")
    monkeypatch.setenv("GRACKLE_DATA_FILE", str(path))
    synthetic = tmp_path / "written" / ".synthetic_cloudy.h5"
    monkeypatch.setattr(common, "SYNTHETIC_FILE", str(synthetic))
    assert common.get_data_file() == str(path)
    assert not synthetic.exists()


def test_yt_example_needs_yt(monkeypatch):
    monkeypatch.setitem(sys.modules, "yt", None)
    with pytest.raises(SystemExit, match="yt is required"):
        yt_grackle.main()
