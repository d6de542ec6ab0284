"""The port's C ABI: grackle_tpu_torch.cshim_build, csrc/grackle_tpu_shim.cpp
and grackle_tpu_torch.cshim_bridge, on the CPU.

The port's generator writes the grackle_tpu.h, params_marshal.inc and
params_defaults.inc and Fortran module that clib/gen_header.py writes
(run on a copy of it), apart from the lines that name the package; the
committed csrc/params_access.inc is its access table.  The unedited
examples compile against the port's ``libgrackle_tpu.so`` and run with
``GRACKLE_TPU_TORCH_DEVICE=cpu``: c_example.c (against the f64 and the
float library), c_legacy_api_example.c and cxx_example.cpp print values
(six digits) within 1e-5 relative of the JAX package's Python API on the
same inputs; dynamic_api_example.c, cxx_omp_example.cpp (host threads),
cxx_grid_example.cpp (ghost zones, with the committed chunked data file;
``-m slow``: about 20 s) and, where gfortran is, fortran_example.f90 with
the port's generated module print their success markers.  Without
``GRACKLE_TPU_TORCH_DEVICE`` (``cuda``) initialization fails on a host
without a card.  The bridge's
ghost zones and full-grid Sobolev stencil match the port's
``solve_chemistry_grid``.  Nothing under clib/ is built or written: the
port builds into grackle_tpu_torch/_build/.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import grackle_tpu
from grackle_tpu_torch import cshim_bridge, cshim_build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIB = os.path.join(REPO, "clib")
EXAMPLES = os.path.join(REPO, "examples")
#: the C examples print %g: six significant digits
PRINT_RTOL = 1e-5

needs_toolchain = pytest.mark.skipif(
    not (shutil.which("g++") and shutil.which("gcc")),
    reason="no C toolchain")


@pytest.fixture(scope="module")
def clib_generated(tmp_path_factory):
    """clib/gen_header.py's outputs, from a copy of it run in a scratch
    directory (tests/test_code_examples.py's recipe): nothing is written
    under clib/."""
    work = tmp_path_factory.mktemp("gen")
    (work / "clib" / "src").mkdir(parents=True)
    shutil.copy(os.path.join(CLIB, "gen_header.py"), work / "clib")
    os.symlink(os.path.join(REPO, "grackle_tpu"), work / "grackle_tpu")
    r = subprocess.run([sys.executable, "gen_header.py"],
                       cwd=str(work / "clib"), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return work / "clib"


def _differing_lines(got, want):
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want)
    return [(g, w) for g, w in zip(got, want) if g != w]


def test_header_matches_clib_generator(clib_generated):
    """The same header apart from its opening comment's lines that name
    the generator and the bridge; the same generated includes apart from
    their first line, which names the generator."""
    with open(clib_generated / "include" / "grackle_tpu.h") as fh:
        diff = _differing_lines(cshim_build.header_text(), fh.read())
    assert diff, "the port's header names its own generator and bridge"
    for got, want in diff:
        assert ("grackle_tpu_torch" in got or "PyTorch" in got
                or "analogue of the reference" in got), (got, want)
        assert got.startswith(" *") or got.startswith("/*"), got
    for name, text in (("params_marshal.inc", cshim_build.marshal_text()),
                       ("params_defaults.inc",
                        cshim_build.defaults_text())):
        with open(clib_generated / "src" / name) as fh:
            diff = _differing_lines(text, fh.read())
        assert len(diff) == 1 and "cshim_build.py" in diff[0][0], name
    with open(os.path.join(cshim_build.CSRC, "params_access.inc")) as fh:
        assert fh.read() == cshim_build.access_text()
    with open(os.path.join(CLIB, "src", "params_access.inc")) as fh:
        diff = _differing_lines(cshim_build.access_text(), fh.read())
    assert len(diff) == 1 and "cshim_build.py" in diff[0][0]


def test_fortran_module_matches_clib_generator(clib_generated):
    """The port's BIND(C) module is clib/gen_header.py's but for the
    opening comment's lines that name the generator; clib's committed
    module is that generator's output."""
    with open(clib_generated / "grackle_tpu_fortran.f90") as fh:
        fresh = fh.read()
    with open(os.path.join(CLIB, "grackle_tpu_fortran.f90")) as fh:
        assert fh.read() == fresh
    diff = _differing_lines(cshim_build.fortran_text(), fresh)
    assert diff, "the port's module names its own generator"
    for got, want in diff:
        assert got.startswith("! ") and want.startswith("! "), (got, want)
        assert "gen_header.py" not in got and "TPU" not in got, got
    cshim_build.generate()
    with open(cshim_build.FORTRAN_MODULE) as fh:
        assert fh.read() == cshim_build.fortran_text()


def test_build_stays_in_the_port():
    """Every file the build reads or writes is the port's: its sources
    in csrc/, its outputs under _build/; the library and include are
    clib/'s names."""
    pkg = os.path.dirname(cshim_build.__file__)
    out = os.path.join(cshim_build.LIB_DIR, "libgrackle_tpu.so")
    assert cshim_build.LIBRARY == out
    assert os.path.commonpath([cshim_build.BUILD_DIR, pkg]) == pkg
    for path in cshim_build.SOURCES:
        assert os.path.dirname(path) == cshim_build.CSRC
    cmd = " ".join(cshim_build.build_command(out))
    assert CLIB not in cmd and "python3-config" not in cmd
    assert "-lpython" in cmd and "GRACKLE_FLOAT_4" not in cmd
    float_lib = cshim_build.library_path(4)
    assert os.path.dirname(float_lib) != cshim_build.LIB_DIR
    assert os.path.commonpath([float_lib, pkg]) == pkg
    assert "-DGRACKLE_FLOAT_4" in cshim_build.build_command(float_lib, 4)


@needs_toolchain
def test_library_defines_every_header_name():
    """The port's library defines every function and global the header
    declares: a host code links it as it links clib/'s."""
    import re

    lib = cshim_build.build()
    header = cshim_build.header_text()
    declared = set(re.findall(r"^\w[\w\s*]*?\b(\w+)\(", header, re.M))
    declared |= set(re.findall(r"^extern \w+ \*?(\w+);", header, re.M))
    declared -= {"typedef"}
    r = subprocess.run(["nm", "-D", "--defined-only", lib],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    defined = {line.split()[-1] for line in r.stdout.splitlines()}
    assert len(declared) >= 35
    assert declared <= defined, sorted(declared - defined)


def _compile(tmp_path, src, extra=(), float_bytes=8, compiler=None):
    """One example linked against the port's library of ``float_bytes``
    (a float host defines GRACKLE_FLOAT_4, as the library was built)."""
    lib_dir = os.path.dirname(cshim_build.build(float_bytes))
    if float_bytes == 4:
        extra = ("-DGRACKLE_FLOAT_4", *extra)
    compiler = compiler or ("g++" if src.endswith(".cpp") else "gcc")
    exe = str(tmp_path / os.path.splitext(src)[0])
    r = subprocess.run(
        [compiler, *extra, "-I" + cshim_build.INCLUDE_DIR,
         os.path.join(EXAMPLES, src), "-L" + lib_dir, "-lgrackle_tpu",
         "-Wl,-rpath," + lib_dir, "-o", exe],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return exe


def _run(exe, marker, *args):
    """A host that solves, on the CPU: its marker, and the kernel
    launches its bridge counted in GRACKLE_TPU_TORCH_LAUNCH_LOG (none:
    CPU tensors take the twin)."""
    log = os.path.join(os.path.dirname(exe), "launches")
    env = cshim_build.run_env("cpu")
    env["GRACKLE_TPU_TORCH_LAUNCH_LOG"] = log
    r = subprocess.run([exe, *args], capture_output=True, text=True,
                       timeout=300, env=env, cwd=os.path.dirname(exe))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert marker in r.stdout
    with open(log) as fh:
        assert fh.read() == "0"
    return r.stdout


def _printed(stdout):
    """The example's ``name[0] = value`` lines as {name: value}."""
    out = {}
    for line in stdout.splitlines():
        if "[0] = " in line:
            name, val = line.split("[0] = ")
            out[name] = float(val)
        elif "[0] after solve = " in line:
            name, val = line.split("[0] after solve = ")
            out[name] = float(val)
    return out


@pytest.fixture(scope="module")
def jax_reference():
    """examples/c_example.c's problem through the JAX package's Python
    API: 8 cells, 9 species, T ~ 1e4 K, one 1-Myr solve, then the
    derived fields of the new state; each value at cell 0."""
    from grackle_tpu.utilities.physical_constants import mass_hydrogen_cgs

    cd = grackle_tpu.chemistry_data()
    cd.use_grackle = 1
    cd.with_radiative_cooling = 1
    cd.primordial_chemistry = 2
    cd.metal_cooling = 0
    cd.UVbackground = 0
    cd.density_units = 1.67262171e-24
    cd.length_units = 3.0857e21
    cd.time_units = 3.1556952e13
    cd.initialize()
    tiny, n = 1.0e-20, 8
    f = {"density": np.ones(n), "HI": np.full(n, 0.76),
         "HII": np.full(n, tiny), "HM": np.full(n, tiny),
         "HeI": np.full(n, 0.24), "HeII": np.full(n, tiny),
         "HeIII": np.full(n, tiny), "H2I": np.full(n, tiny),
         "H2II": np.full(n, tiny)}
    f["de"] = f["HII"] + f["HeII"] / 4.0 + f["HeIII"] / 2.0
    v = cd.length_units / cd.time_units
    f["energy"] = np.full(n, 1.0e4 / 1.2 / (v * v * mass_hydrogen_cgs
                                            / 1.3806504e-16)
                          / (5.0 / 3.0 - 1.0))
    new_f, _ = cd.solve_chemistry(f, 3.15e7 * 1e6 / cd.time_units)
    new_f = {k: np.asarray(v) for k, v in new_f.items()}
    out = {"HI": new_f["HI"][0], "HII": new_f["HII"][0]}
    for name in ("cooling_time", "temperature", "pressure", "gamma"):
        out[name] = np.asarray(
            getattr(cd, f"calculate_{name}")(new_f))[0]
    return out


@needs_toolchain
@pytest.mark.parametrize("src, marker, extra, float_bytes", [
    ("c_example.c", "C_EXAMPLE_SUCCESS", (), 8),
    ("c_legacy_api_example.c", "C_LEGACY_EXAMPLE_SUCCESS",
     ("-Wno-deprecated-declarations",), 8),
    ("c_example.c", "C_EXAMPLE_SUCCESS", (), 4),
], ids=["c_example.c-C_EXAMPLE_SUCCESS-extra0",
        "c_legacy_api_example.c-C_LEGACY_EXAMPLE_SUCCESS-extra1",
        "c_example.c-float"])
def test_c_example_runs_on_the_port(tmp_path, jax_reference, src, marker,
                                    extra, float_bytes):
    """The unedited example, linked against the port's library, on the
    CPU: its marker, and every printed value against the JAX package.
    The float library's fields are float: the inputs round to float and
    the f64 solve's results round back, well inside the six printed
    digits."""
    clib_header = os.path.join(CLIB, "include", "grackle_tpu.h")
    before = open(clib_header).read() if os.path.exists(clib_header) \
        else None
    exe = _compile(tmp_path, src, extra, float_bytes)
    got = _printed(_run(exe, marker))
    want = jax_reference
    assert got and set(got) <= set(want), got
    for name, val in got.items():
        np.testing.assert_allclose(val, want[name], rtol=PRINT_RTOL,
                                   err_msg=name)
    if before is not None:
        assert open(clib_header).read() == before


@pytest.fixture(scope="module")
def jax_cxx_reference():
    """examples/cxx_example.cpp's problem through the JAX package's
    Python API: 16 cells of 6 species, ionized at T ~ 1e5 K, the cooling
    time, then HI after a solve of 0.01."""
    cd = grackle_tpu.chemistry_data()
    cd.use_grackle = 1
    cd.primordial_chemistry = 1
    cd.density_units = 1.67262171e-24
    cd.length_units = 3.0857e21
    cd.time_units = 3.1556952e13
    cd.initialize()
    n, v = 16, cd.length_units / cd.time_units
    f = {"density": np.ones(n), "HI": np.full(n, 1e-20),
         "HII": np.full(n, 0.76), "HeI": np.full(n, 0.24),
         "HeII": np.full(n, 1e-20), "HeIII": np.full(n, 1e-20),
         "de": np.full(n, 0.76),
         "energy": np.full(n, 1.0e5 / 0.6 / (v * v * 1.67262171e-24
                                             / 1.3806504e-16)
                           / (5.0 / 3.0 - 1.0))}
    cooling_time = np.asarray(cd.calculate_cooling_time(f))[0]
    new_f, _ = cd.solve_chemistry(f, 0.01)
    return {"cooling_time": cooling_time, "HI": np.asarray(new_f["HI"])[0]}


@needs_toolchain
def test_cxx_example_runs_on_the_port(tmp_path, jax_cxx_reference):
    """examples/cxx_example.cpp (g++) on the port: its marker, and its
    printed cooling time and HI against the JAX package."""
    got = _printed(_run(_compile(tmp_path, "cxx_example.cpp"),
                        "CXX_EXAMPLE_SUCCESS"))
    assert set(got) == set(jax_cxx_reference), got
    for name, val in got.items():
        np.testing.assert_allclose(val, jax_cxx_reference[name],
                                   rtol=PRINT_RTOL, err_msg=name)


@needs_toolchain
def test_dynamic_api_example_runs_on_the_port(tmp_path):
    """examples/dynamic_api_example.c: string-keyed access to every
    parameter, pure C over csrc/params_access.inc; it starts no
    interpreter, so it runs without PYTHONPATH."""
    exe = _compile(tmp_path, "dynamic_api_example.c")
    r = subprocess.run([exe], capture_output=True, text=True, timeout=60,
                       env={"PATH": os.environ.get("PATH", "")})
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "DYNAPI_EXAMPLE_SUCCESS" in r.stdout
    counts = {int: 0, float: 0, str: 0}
    for ptype, _ in cshim_build.PARAMETER_REGISTRY.values():
        counts[ptype] += 1
    assert (f"{counts[int]} int, {counts[float]} double, {counts[str]} "
            f"string params") in r.stdout


@needs_toolchain
def test_cxx_omp_example_runs_on_the_port(tmp_path):
    """examples/cxx_omp_example.cpp (g++ -fopenmp): four host threads
    solve at once and match a serial sweep, and two contexts driven from
    two threads keep their own tables; the program checks both."""
    out = _run(_compile(tmp_path, "cxx_omp_example.cpp",
                        extra=("-fopenmp",)), "CXX_OMP_EXAMPLE_SUCCESS")
    assert out.count("threaded HI[0]=") == 4


@needs_toolchain
@pytest.mark.slow
def test_cxx_grid_example_runs_on_the_port(tmp_path):
    """examples/cxx_grid_example.cpp with the committed chunked data file
    (tests/data/h5/synthetic_gz.h5, read by data/h5read.py): chemistry
    0-3 with metal cooling and the UVB on a ghost-zoned grid; every
    ghost value comes back bit-identical (the program checks)."""
    data = os.path.join(REPO, "tests", "data", "h5", "synthetic_gz.h5")
    _run(_compile(tmp_path, "cxx_grid_example.cpp"),
         "CXX_GRID_EXAMPLE_SUCCESS", data)


@pytest.mark.skipif(not shutil.which("gfortran"),
                    reason="no gfortran in this environment")
def test_fortran_example_runs_on_the_port(tmp_path):
    """examples/fortran_example.f90 with the port's generated module,
    linked against the port's library, on the CPU."""
    lib_dir = os.path.dirname(cshim_build.build())
    exe = str(tmp_path / "fortran_example")
    r = subprocess.run(
        ["gfortran", cshim_build.FORTRAN_MODULE,
         os.path.join(EXAMPLES, "fortran_example.f90"), "-J",
         str(tmp_path), "-L" + lib_dir, "-lgrackle_tpu",
         "-Wl,-rpath," + lib_dir, "-o", exe],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    _run(exe, "FORTRAN_EXAMPLE_SUCCESS")


@needs_toolchain
def test_c_example_without_a_card_fails(tmp_path):
    """GRACKLE_TPU_TORCH_DEVICE defaults to cuda: on a host without a
    card the C call reports failure; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    exe = _compile(tmp_path, "c_example.c")
    env = cshim_build.run_env("cpu")
    del env["GRACKLE_TPU_TORCH_DEVICE"]
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(tmp_path))
    assert r.returncode != 0
    assert "C_EXAMPLE_SUCCESS" not in r.stdout
    assert "device=\"cpu\"" in r.stderr
    assert "Error in initialize_chemistry_data" in r.stderr


def test_bridge_ghost_zones_and_stencil(monkeypatch):
    """The bridge on caller-owned C-order arrays of a 3-D grid with ghost
    zones and H2 self-shielding 1: the active region evolves as the
    port's solve_chemistry_grid evolves it (the stencil reads the ghost
    zones), the ghost zones are untouched, and a derived field fills only
    the active region."""
    monkeypatch.setenv("GRACKLE_TPU_TORCH_DEVICE", "cpu")
    shape, start, end = (6, 5, 4), (1, 1, 1), (4, 3, 2)  # (k, j, i)
    sl = tuple(slice(s, e + 1) for s, e in zip(start, end))
    cd = chip_smoke.answer_chem("cpu", primordial_chemistry=2,
                                H2_self_shielding=1)
    f = {k: v.reshape(shape) for k, v in chip_smoke.answer_state(
        cd, n=int(np.prod(shape))).items()}
    params = {name: cd[name] for name in cd.parameter_names()}
    units = {k: getattr(cd, k) for k in (
        "comoving_coordinates", "density_units", "length_units",
        "time_units", "a_units", "a_value")}
    handle = cshim_bridge.initialize_context(params, units)
    assert handle > 0

    want, _ = cd.solve_chemistry_grid(
        f, chip_smoke.GRID_DT, grid_start=start, grid_end=end,
        grid_dx=chip_smoke.GRID_DX)
    inv = {v: k for k, v in cshim_bridge._NAME_MAP.items()}
    arrays = {name: np.ascontiguousarray(val) for name, val in f.items()}
    ptrs = {inv[name]: arr.ctypes.data for name, arr in arrays.items()}
    # the C grid is (i, j, k) fastest-first: the reverse of the C order
    grid = {"grid_rank": 3, "grid_dimension": list(shape[::-1]),
            "grid_start": list(start[::-1]), "grid_end": list(end[::-1]),
            "grid_dx": chip_smoke.GRID_DX}
    assert cshim_bridge.solve_chemistry(handle, units, grid, ptrs,
                                        chip_smoke.GRID_DT, 8) == 1
    for name, arr in arrays.items():
        np.testing.assert_allclose(arr, want[name], rtol=1e-12,
                                   err_msg=name)
        ghost = np.ones(shape, bool)
        ghost[sl] = False
        assert np.array_equal(arr[ghost], f[name][ghost]), name

    out = np.zeros(shape)
    assert cshim_bridge.calculate_temperature(
        handle, units, grid, ptrs, out.ctypes.data, 8) == 1
    active = {k: v[sl].reshape(-1) for k, v in arrays.items()}
    np.testing.assert_allclose(
        out[sl].reshape(-1), cd.calculate_temperature(active).numpy(),
        rtol=1e-12)
    assert not out[ghost].any()
    assert cshim_bridge.get_parameter(handle, "H2_self_shielding") == 1
    assert cshim_bridge.free_context(handle) == 1
    assert cshim_bridge.solve_chemistry(handle, units, grid, ptrs,
                                        1e-4, 8) == 0
