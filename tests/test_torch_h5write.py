"""The port's HDF5 writer (grackle_tpu_torch/data/h5write.py) and its two
synthetic-file writers (data/synthetic.make_synthetic_data_file,
make_synthetic_old_style_file) against h5py and the JAX package.

h5py (libhdf5) looks every name up through the group B-trees where
data/h5read.py walks every entry, so each file the port writes is opened
with h5py and every group, dataset and attribute is looked up by its
full path: the port's synthetic files against the JAX writers' files,
and each writer case against the same content written by h5py, names,
dtypes, shapes and values equal at rtol 0.  Then h5read and the JAX
loaders on the port's files, the refusals, and a solve from a written
file against the same solve from memory.
"""

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu.data import cloudy as jcloudy
from grackle_tpu.data import uvb as juvb
from grackle_tpu.config import ChemistryConfig as JConfig
from grackle_tpu.data.synthetic import (
    make_synthetic_data_file as jax_data_file,
    make_synthetic_old_style_file as jax_old_style_file)
from grackle_tpu.units import CodeUnits as JCodeUnits
from grackle_tpu_torch.api import ChemistryData
from grackle_tpu_torch.data import h5write
from grackle_tpu_torch.data.synthetic import (
    make_synthetic_data_file, make_synthetic_old_style_file,
    synthetic_cloudy_groups, synthetic_old_style_groups)
from tests.test_torch_h5read import UNITS

torch.set_num_threads(1)

KINDS = ["new", "old4", "old5"]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each synthetic file as the port and as the JAX package write it:
    {kind: (port's path, JAX's path)}."""
    tmp = tmp_path_factory.mktemp("h5write")
    out = {}
    for kind, port, jax in [
            ("new", make_synthetic_data_file, jax_data_file),
            ("old4", lambda p: make_synthetic_old_style_file(p, 4),
             lambda p: jax_old_style_file(p, 4)),
            ("old5", lambda p: make_synthetic_old_style_file(p, 5),
             lambda p: jax_old_style_file(p, 5))]:
        out[kind] = (str(port(str(tmp / f"port_{kind}.h5"))),
                     str(jax(str(tmp / f"jax_{kind}.h5"))))
    return out


def _paths(f):
    """Every path of an h5py file, the root first, in visit order."""
    names = ["/"]
    f.visit(lambda name: names.append("/" + name))
    return names


def _same(got, want, where):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, where
    assert got.shape == want.shape, where
    assert got.tobytes() == want.tobytes(), where


def assert_same_by_path(got_path, want_path):
    """h5py opens both files; every group, dataset and attribute of
    ``want_path`` is looked up by its full path in both (libhdf5's name
    lookup), with equal types, dtypes, shapes and bytes; returns the
    count of values compared."""
    count = 0
    with h5py.File(got_path, "r") as got, h5py.File(want_path, "r") as want:
        assert _paths(got) == _paths(want)
        for path in _paths(want):
            g, w = got[path], want[path]
            assert type(g) is type(w), path
            assert sorted(g.attrs) == sorted(w.attrs), path
            for key in w.attrs:
                _same(got[path].attrs[key], w.attrs[key], f"{path}@{key}")
                count += 1
            if isinstance(w, h5py.Dataset):
                _same(g[()], w[()], path)
                count += 1
    return count


@pytest.mark.parametrize("kind", KINDS)
def test_files_equal_jax_writers(written, kind):
    """(a) The port's file against the JAX writer's, every path looked up
    by h5py."""
    port, jax = written[kind]
    assert assert_same_by_path(port, jax) == {"new": 46, "old4": 15,
                                              "old5": 17}[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_h5read_reads_written_files(written, kind):
    """(b) data/h5read.py on the port's file: every table and attribute
    bit-identical to the tables in memory."""
    groups = {"new": synthetic_cloudy_groups,
              "old4": lambda: synthetic_old_style_groups(4),
              "old5": lambda: synthetic_old_style_groups(5)}[kind]()
    compared = chip_smoke.file_vs_groups(written[kind][0], groups)
    assert compared == {"new": 49, "old4": 15, "old5": 17}[kind]


def _assert_same_tables(got, want, where):
    """Every field of two JAX table dataclasses equal (rtol 0)."""
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        assert (w is None) == (g is None), f"{where} {field.name}"
        if w is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{where} {field.name}")


@pytest.mark.parametrize("kind", KINDS)
def test_jax_loaders_equal(written, kind):
    """(c) The JAX package's load_cloudy_table (with and without heating
    and MMW) and load_uvb_table give the same tables from the port's file
    as from the JAX writer's."""
    port, jax = written[kind]
    assert jcloudy.is_old_style(port) == jcloudy.is_old_style(jax) \
        == (kind != "new")
    groups = [("Primordial", True), ("Metals", False)] if kind == "new" \
        else [("Metals", False)]
    units = JCodeUnits(**UNITS)
    for group, mmw in groups:
        for heating in (False, True):
            _assert_same_tables(
                jcloudy.load_cloudy_table(port, group, units, heating, mmw),
                jcloudy.load_cloudy_table(jax, group, units, heating, mmw),
                group)
    if kind == "new":
        cfg = JConfig(primordial_chemistry=3, self_shielding_method=3)
        got = juvb.load_uvb_table(port, cfg)
        assert got.info == "synthetic UVB for grackle_tpu tests"
        _assert_same_tables(got, juvb.load_uvb_table(jax, cfg), "UVBRates")


# (d) writer cases: each content written by h5write and by h5py, then
# compared path by path through h5py


def _attrs(f):
    rng = np.random.default_rng(1)
    f.attrs["scalar_i8"] = np.int64(-3)
    f.attrs["scalar_f8"] = 2.5
    f.attrs["array_i8"] = np.arange(4, dtype=np.int64)
    f.attrs["array_f8"] = rng.standard_normal((2, 3))
    f.attrs["bytes"] = np.bytes_("erg/s")
    g = f.create_group("g")
    g.attrs["Rank"] = np.int64(3)
    d = g.create_dataset("d", data=rng.standard_normal(7))
    d.attrs["Dimension"] = np.array([7], dtype=np.int64)
    d.attrs["Temperature"] = 10.0 ** np.linspace(1.0, 9.0, 81)


def _bytes_scalar(f):
    f.create_dataset("Info", data=np.bytes_(
        "synthetic UVB for grackle_tpu tests"))
    f.create_dataset("one", data=np.bytes_("x"))


def _ranks(f):
    rng = np.random.default_rng(2)
    f.create_dataset("rank0", data=np.float64(1.5))
    for rank, shape in enumerate([(7,), (3, 4), (2, 3, 4), (2, 3, 2, 5),
                                  (2, 1, 3, 2, 4)], start=1):
        f.create_dataset(f"rank{rank}", data=rng.standard_normal(shape))
        f.create_dataset(f"int{rank}", data=np.arange(
            np.prod(shape), dtype=np.int64).reshape(shape) - 5)
    # not C-contiguous: written in C order
    f.create_dataset("transposed", data=np.arange(12.0).reshape(3, 4).T)


def _nested_and_empty(f):
    f.create_group("a/b/c")
    f.create_group("empty")
    f["a"].create_group("empty_too")
    f.create_dataset("a/b/c/d", data=np.arange(3.0))
    f["a/b"].create_dataset("e", data=np.int64(4))


def _group_of(n):
    """``n`` members whose names need byte-order sorting: capitals before
    "_" before lower case, "k10" before "k2"."""
    prefixes = ["k", "Z", "_", "a", "B", "k1"]

    def write(f):
        g = f.create_group("many")
        for i in range(n):
            g.create_dataset(f"{prefixes[i % len(prefixes)]}{i}",
                             data=np.int64(i))
        f.create_dataset("after", data=np.float64(n))
    return write


WRITES = {
    "attributes": _attrs,
    "bytes_scalar": _bytes_scalar,
    "ranks_0_to_5": _ranks,
    "nested_and_empty_groups": _nested_and_empty,
    "group_of_9": _group_of(9),
    "group_of_40": _group_of(40),
    "group_of_300": _group_of(300),  # a two-level group B-tree
}


@pytest.mark.parametrize("case", list(WRITES))
def test_writes_like_h5py(tmp_path, case):
    ours, theirs = tmp_path / "h5write.h5", tmp_path / "h5py.h5"
    with h5write.File(ours, "w") as f:
        WRITES[case](f)
    with h5py.File(theirs, "w") as f:
        WRITES[case](f)
    assert assert_same_by_path(ours, theirs) > 0
    assert sorted(os.listdir(tmp_path)) == ["h5py.h5", "h5write.h5"]


def _dataset(data, **kw):
    return lambda f: f.create_dataset("x", data=data, **kw)


def _attr(value):
    def write(f):
        f.attrs["x"] = value
    return write


def _link(f):
    f.create_group("g")
    f["h"] = f["g"]


UNSUPPORTED = {
    "float16": _dataset(np.zeros(3, np.float16)),
    "float32": _dataset(np.zeros(3, np.float32)),
    "int32": _dataset(np.zeros(3, np.int32)),
    "complex": _dataset(np.zeros(3, np.complex128)),
    "object": _dataset(np.array([1, "a"], dtype=object)),
    "big_endian": _dataset(np.zeros(3, ">f8")),
    "bool": _attr(True),
    "str_attribute": _attr("variable-length text"),
    "zero_size": _dataset(np.zeros((0, 3))),
    "chunks": _dataset(np.zeros(4), chunks=(2,)),
    "compression": _dataset(np.zeros(4), compression="gzip"),
    "no_data": lambda f: f.create_dataset("x", shape=(3,), dtype="f8"),
    "link": _link,
    "large_attribute": _attr(np.zeros(9000)),
}


@pytest.mark.parametrize("case", list(UNSUPPORTED))
def test_unsupported_raises(tmp_path, case):
    """Each refusal raises NotImplementedError at the call, and the file
    whose content failed is not written."""
    path = tmp_path / "x.h5"
    with pytest.raises(NotImplementedError, match="h5write"):
        with h5write.File(path, "w") as f:
            UNSUPPORTED[case](f)
    assert os.listdir(tmp_path) == []


def test_open_modes_and_names(tmp_path):
    for mode in ("r", "a", "w-", "x", "r+"):
        with pytest.raises(NotImplementedError, match="mode"):
            h5write.File(tmp_path / "x.h5", mode)
    with h5write.File(tmp_path / "x.h5", "w") as f:
        f.create_group("g")
        with pytest.raises(ValueError, match="already exists"):
            f.create_group("g")
        with pytest.raises(ValueError, match="not a valid"):
            f.create_group("bad\0name")
        assert "g" in f and "/g" in f and "g/h" not in f
        assert f["/"] is f and f["g"].name == "/g"
        with pytest.raises(KeyError):
            f["missing"]
    with pytest.raises(ValueError, match="closed"):
        f.create_group("late")


def test_same_content_same_bytes(tmp_path):
    """Two writes of the synthetic file, at two names, give the same
    bytes; the superblock's end-of-file address is the file's size."""
    a = make_synthetic_data_file(str(tmp_path / "a.h5"))
    b = make_synthetic_data_file(str(tmp_path / "b.h5"))
    data = open(a, "rb").read()
    assert data == open(b, "rb").read()
    assert int.from_bytes(data[40:48], "little") == len(data)


def _chem(source, **kw):
    cd = ChemistryData()
    cd.use_grackle = 1
    cd.with_radiative_cooling = 1
    chip_smoke._units(cd)
    for key, val in kw.items():
        setattr(cd, key, val)
    if isinstance(source, str):
        cd.grackle_data_file = source
        cd.initialize(device="cpu")
    else:
        cd.initialize(device="cpu", cloudy_data=source)
    return cd


@pytest.mark.parametrize("kind", ["new", "old5"])
def test_solve_from_written_file_equals_memory(written, kind):
    """(e) The port's CPU solve of 256 cells (and the cooling time) from
    its own written file against the same from the tables in memory, bit
    for bit: the 12-species flagship chemistry with the UVB, and the
    old-style rank-5 chemistry-1 solve of chip_smoke phase 4e."""
    path = written[kind][0]
    if kind == "new":
        kw = dict(primordial_chemistry=3, dust_chemistry=1, metal_cooling=1,
                  UVbackground=1, self_shielding_method=3)
        from_file = _chem(path, **kw)
        in_memory = _chem(synthetic_cloudy_groups(), **kw)
    else:
        from_file = chip_smoke.old_style_chem("cpu", 5, path)
        in_memory = chip_smoke.old_style_chem("cpu", 5)
        assert from_file.context.cloudy_metal.grid_rank == 5
    state = chip_smoke.answer_state(in_memory, n=256)
    got, got_d = from_file.solve_chemistry(state, 1.0e-4)
    want, want_d = in_memory.solve_chemistry(state, 1.0e-4)
    assert not chip_smoke.bit_differences(got, got_d, want, want_d)
    assert torch.equal(from_file.calculate_cooling_time(got),
                       in_memory.calculate_cooling_time(want))
