"""grackle_tpu_torch.data.h5read against h5py, and the loaders built on it
against the JAX package's.

h5py (libhdf5) writes each file in ``tmp_path``; the port's reader, which
uses numpy, struct and zlib only, must give back the same groups, arrays,
dtypes (in native byte order), shapes and attributes, bit for bit.  What
it does not read raises NotImplementedError naming the feature and the
file.  The committed fixtures of tests/data/h5/ (scripts/make_h5_fixtures.py)
read as h5py reads them.  The JAX package's loaders and the port's give
the same tables from the same files (bit-identical: both compute the same
numpy expressions), and a port context whose tables come from a file
solves as one given the same tables in memory, bit for bit.
"""

import os

import h5py
import numpy as np
import pytest
import torch

import chip_smoke
from grackle_tpu.config import ChemistryConfig as JConfig
from grackle_tpu.data import cloudy as jcloudy
from grackle_tpu.data import uvb as juvb
from grackle_tpu.data.synthetic import (make_synthetic_data_file,
                                        make_synthetic_old_style_file)
from grackle_tpu.units import CodeUnits as JCodeUnits
from grackle_tpu_torch.api import ChemistryData
from grackle_tpu_torch.config import ChemistryConfig as PConfig
from grackle_tpu_torch.data import cloudy as pcloudy
from grackle_tpu_torch.data import h5read
from grackle_tpu_torch.data import uvb as puvb
from grackle_tpu_torch.data.synthetic import (synthetic_cloudy_groups,
                                              synthetic_old_style_groups)
from grackle_tpu_torch.units import CodeUnits as PCodeUnits
from grackle_tpu_torch.utilities.physical_constants import mass_hydrogen_cgs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "h5")
UNITS = dict(comoving_coordinates=0, density_units=mass_hydrogen_cgs,
             length_units=3.0857e21, time_units=3.1556952e13,
             a_units=1.0, a_value=1.0)


def assert_same_value(got, want, where):
    """h5read's value equals h5py's: an array of the same shape, the
    same dtype in native byte order and the same bytes; or an equal
    scalar of the same type."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (where, type(got))
        assert got.shape == want.shape, (where, got.shape, want.shape)
        if want.dtype.kind == "O":
            assert got.dtype.kind == "O", where
            assert [type(x) for x in got.ravel()] == \
                [type(x) for x in want.ravel()], where
            assert list(got.ravel()) == list(want.ravel()), where
        else:
            assert got.dtype == want.dtype.newbyteorder("="), \
                (where, got.dtype, want.dtype)
            assert got.dtype.isnative, where
            assert got.tobytes() == want.astype(got.dtype).tobytes(), where
    else:
        assert type(got) is type(want), (where, type(got), type(want))
        assert got == want, (where, got, want)


def assert_reads_like_h5py(path):
    """Every group, dataset and attribute of ``path`` through h5read
    equals h5py's read of it."""
    def attrs(obj5, obj, where):
        want = dict(obj5.attrs.items())
        got = obj.attrs
        assert sorted(got) == sorted(want), where
        for key, val in want.items():
            assert_same_value(got[key], val, f"{where}@{key}")

    def walk(g5, g, where):
        attrs(g5, g, where)
        assert g.keys() == list(g5.keys()), where
        assert len(g) == len(g5), where
        for name, item5 in g5.items():
            item = g[name]
            if isinstance(item5, h5py.Group):
                assert isinstance(item, h5read.Group), where + name
                walk(item5, item, f"{where}{name}/")
                continue
            assert isinstance(item, h5read.Dataset), where + name
            assert item.shape == item5.shape, where + name
            attrs(item5, item, where + name)
            assert_same_value(item[()], item5[()], where + name)
            if item5.shape:
                assert_same_value(item[...], item5[...], where + name)

    with h5py.File(path, "r") as f5, h5read.File(path) as f:
        walk(f5, f, "/")
        return len(f5)


def _content(f, libver, storage):
    """The values h5read must read back: f32, f64 and int32 arrays in
    both byte orders, with a shape that leaves partial edge chunks;
    scalars; fixed- and variable-length strings; attributes on the root,
    a group and a dataset."""
    rng = np.random.RandomState(7)
    kw = {}
    if storage.startswith("chunked"):
        kw = dict(chunks=(2, 3), compression="gzip" if "gzip" in storage
                  else None, shuffle="shuffle" in storage,
                  fletcher32="fletcher32" in storage)
    elif storage == "compact":
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        kw = dict(dcpl=dcpl)
    f.attrs["old_style"] = np.int64(1)
    f.attrs["grid"] = rng.uniform(size=4)
    f.attrs["name"] = np.bytes_("fixed")
    f.attrs["vname"] = "variable"
    f.attrs["be_ints"] = np.arange(3, dtype=">i4")
    g = f.create_group("Tables/Inner")
    g.attrs["Rank"] = np.int64(2)
    for dtype in ("<f4", ">f4", "<f8", ">f8", "<i4", ">i4"):
        vals = rng.uniform(-1e3, 1e3, size=(5, 7))
        if dtype[1] == "f":
            vals[0, :3] = [np.inf, -0.0, 1e-310]
        d = g.create_dataset(f"a{dtype[0] == '>' and 'be' or 'le'}"
                             f"{dtype[1:]}", data=vals.astype(dtype), **kw)
        d.attrs["Dimension"] = np.array([5, 7], dtype=np.int64)
        d.attrs["Temperature"] = rng.uniform(size=6)
    if "chunks" in kw:
        kw["chunks"] = (2,)
    f.create_dataset("names", data=np.array([b"ab", b"cde", b""]), **kw)
    # libhdf5 refuses fletcher32 on variable-length data
    f.create_dataset("vnames", data=["x", "yz", "long string"],
                     dtype=h5py.string_dtype(),
                     **{k: v for k, v in kw.items() if k != "fletcher32"})
    kw.pop("chunks", None)
    for key in ("compression", "shuffle", "fletcher32"):
        kw.pop(key, None)
    f.create_dataset("Info", data=np.bytes_("synthetic UVB"), **kw)
    f.create_dataset("VInfo", data="variable info",
                     dtype=h5py.string_dtype(), **kw)
    f.create_dataset("scalar", data=np.float64(2.5), **kw)
    f.create_dataset("count", data=np.int32(-4), **kw)


@pytest.mark.parametrize("libver, storage", [
    ("earliest", "contiguous"),
    ("earliest", "compact"),
    ("earliest", "chunked"),
    ("earliest", "chunked-gzip"),
    ("earliest", "chunked-shuffle"),
    ("earliest", "chunked-fletcher32"),
    ("earliest", "chunked-gzip-shuffle-fletcher32"),
    ("latest", "contiguous"),
    ("latest", "compact"),
    ("earliest", "40-links"),
    ("earliest", "300-links"),
])
def test_reads_like_h5py(tmp_path, libver, storage):
    """Each layout, filter, type, byte order, string kind and attribute
    place h5read supports, written by h5py; under "earliest" a group of
    40 links spans several symbol-table nodes of a one-level B-tree, and
    one of 300 a two-level B-tree."""
    path = tmp_path / "file.h5"
    links = int(storage.split("-")[0]) if storage.endswith("links") else 0
    with h5py.File(path, "w", libver=libver) as f:
        if links:
            g = f.create_group("many")
            for i in range(links):
                g.create_dataset(f"d{i:03d}", data=np.arange(i % 7 + 1.0))
        else:
            _content(f, libver, storage)
    assert assert_reads_like_h5py(path) >= 1
    if links:
        with h5read.File(path) as f:
            assert len(f["many"]) == links
            assert f[f"/many/d{links - 1:03d}"][...].tolist() == \
                list(range((links - 1) % 7 + 1))


def _dense_links(f):
    g = f.create_group("many")
    for i in range(40):
        g.create_dataset(f"d{i:02d}", data=np.float64(i))
    return lambda h: h["many"].keys()


def _dense_attrs(f):
    for i in range(40):
        f.attrs[f"a{i:02d}"] = np.float64(i)
    return lambda h: h.attrs


def _chunked_latest(f):
    f.create_dataset("c", data=np.arange(100.0), chunks=(10,))
    return lambda h: h["c"][...]


def _lzf(f):
    f.create_dataset("c", data=np.arange(100.0), chunks=(10,),
                     compression="lzf")
    return lambda h: h["c"][...]


def _soft_link(f):
    f.create_dataset("x", data=np.arange(3.0))
    f["y"] = h5py.SoftLink("/x")
    return lambda h: h["y"]


@pytest.mark.parametrize("libver, write, feature", [
    ("latest", _dense_links, "dense link storage"),
    ("latest", _dense_attrs, "dense attribute storage"),
    ("latest", _chunked_latest, "chunk index of data layout v4"),
    ("earliest", _lzf, "filter id 32000"),
    ("earliest", _soft_link, "soft link"),
], ids=["dense-links", "dense-attrs", "layout-v4-chunks", "lzf",
        "soft-link"])
def test_unsupported_raises(tmp_path, libver, write, feature):
    """A feature h5read does not read raises NotImplementedError that
    names it and the file; it never returns a guess."""
    path = tmp_path / "file.h5"
    with h5py.File(path, "w", libver=libver) as f:
        read = write(f)
    with h5read.File(path) as f:
        with pytest.raises(NotImplementedError) as err:
            read(f)
    assert feature in str(err.value) and str(path) in str(err.value)


@pytest.mark.parametrize("name", ["synthetic_gz.h5", "old_style_rank4_gz.h5",
                                  "latest_small.h5"])
def test_committed_fixtures_read_like_h5py(name):
    """The fixtures the card reads (chip_smoke.py phase 4j) read as h5py
    reads them, and hold what they were written from, bit for bit: the
    in-memory synthetic tables (``Info`` is bytes in the file) and
    chip_smoke.latest_small_content()."""
    path = os.path.join(FIXTURES, name)
    assert_reads_like_h5py(path)
    if name == "synthetic_gz.h5":
        compared = chip_smoke.file_vs_groups(path, synthetic_cloudy_groups())
    elif name == "old_style_rank4_gz.h5":
        compared = chip_smoke.file_vs_groups(
            path, synthetic_old_style_groups(4))
    else:
        compared = chip_smoke.latest_vs_content(path)
    assert compared == {"synthetic_gz.h5": 49, "old_style_rank4_gz.h5": 15,
                        "latest_small.h5": 11}[name]


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    """The JAX package's synthetic files: new style, old-style rank 4
    and rank 5."""
    tmp = tmp_path_factory.mktemp("h5")
    return {"new": str(make_synthetic_data_file(tmp / "new.h5")),
            "old4": str(make_synthetic_old_style_file(tmp / "old4.h5", 4)),
            "old5": str(make_synthetic_old_style_file(tmp / "old5.h5", 5))}


_TABLE_FIELDS = ["par1", "par2", "par3", "par4", "par5", "cooling",
                 "heating", "mmw"]


@pytest.mark.parametrize("kind", ["new", "old4", "old5"])
def test_loaders_match_jax(data_files, kind):
    """load_cloudy_table (every group the file has, with and without
    heating and MMW), is_old_style and load_uvb_table of the JAX package
    and of the port on the same file: the same tables bit for bit (the
    same numpy expressions; KERNEL-free host code)."""
    path = data_files[kind]
    assert pcloudy.is_old_style(path) == jcloudy.is_old_style(path) \
        == (kind != "new")
    groups = [("Primordial", True), ("Metals", False)] if kind == "new" \
        else [("Metals", False)]
    for group, mmw in groups:
        for heating in (False, True):
            want = jcloudy.load_cloudy_table(path, group, JCodeUnits(**UNITS),
                                             heating, mmw)
            got = pcloudy.load_cloudy_table(path, group, PCodeUnits(**UNITS),
                                            heating, mmw)
            assert got.grid_rank == want.grid_rank
            assert got.grid_dimension == want.grid_dimension
            for name in _TABLE_FIELDS:
                w, g = getattr(want, name), getattr(got, name)
                assert (w is None) == (g is None), name
                if w is not None:
                    assert g.dtype == torch.float64
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                                  err_msg=f"{group} {name}")
    if kind != "new":
        return
    cfg = dict(primordial_chemistry=3, self_shielding_method=3)
    want = juvb.load_uvb_table(path, JConfig(**cfg))
    got = puvb.load_uvb_table(path, PConfig(**cfg))
    assert got.info == want.info == "synthetic UVB for grackle_tpu tests"
    for name in ["z"] + puvb._UVB_RATE_NAMES:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


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


@pytest.mark.parametrize("kw", [
    dict(primordial_chemistry=3, dust_chemistry=1, metal_cooling=1,
         UVbackground=1, self_shielding_method=3),
    dict(primordial_chemistry=0, metal_cooling=1, UVbackground=1),
], ids=["12species_uvb", "tabulated_uvb"])
def test_solve_from_file_equals_memory(kw):
    """The committed chunked fixture as the context's data file, against
    the same tables built in memory: the tables, then 256 cells of one
    solve and the cooling time, bit for bit."""
    path = os.path.join(FIXTURES, "synthetic_gz.h5")
    from_file = _chem(path, **kw)
    in_memory = _chem(synthetic_cloudy_groups(), **kw)
    for name in ("cloudy_primordial", "cloudy_metal"):
        a = getattr(from_file.context, name)
        b = getattr(in_memory.context, name)
        for field in _TABLE_FIELDS:
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y), (name, field)
    state = chip_smoke.answer_state(in_memory, n=256)
    got, got_d = from_file.solve_chemistry(state, 1.0e-4)
    want, want_d = in_memory.solve_chemistry(state, 1.0e-4)
    assert not chip_smoke.bit_differences(got, got_d, want, want_d)
    assert torch.equal(from_file.calculate_cooling_time(got),
                       in_memory.calculate_cooling_time(want))
