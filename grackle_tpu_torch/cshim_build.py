"""Build the port's C ABI library, ``libgrackle_tpu.so``.

The C API of ``grackle_tpu.h`` (the analogue of the reference's
grackle.h) served by grackle_tpu_torch: ``csrc/grackle_tpu_shim.cpp``
embeds CPython and calls :mod:`grackle_tpu_torch.cshim_bridge`.  This
module is the port's copy of clib/gen_header.py (the header and the
parameter marshaling are generated from ``grackle_tpu_torch.config``'s
registry) plus the build: :func:`build` writes ``grackle_tpu.h``,
``params_marshal.inc``, ``params_defaults.inc`` and the Fortran module
``grackle_tpu_fortran.f90`` into ``grackle_tpu_torch/_build/`` and
compiles the library with ``g++`` into ``grackle_tpu_torch/_build/clib/``
(``build(float_bytes=4)``: ``gr_float = float``, ``-DGRACKLE_FLOAT_4``,
into ``_build/clib_float4/``, as clib's ``make FLOAT=4``), taking
Python's include and link flags from ``sysconfig`` (no ``python3-config``
needed).  It rebuilds only when a source, a generated file or a flag
changes.

A host code compiles against ``_build/include/grackle_tpu.h`` and links
``-L<that clib dir> -lgrackle_tpu -Wl,-rpath,<that clib dir>``, exactly
as it links clib/'s library.  At run time the embedded interpreter must
find grackle_tpu_torch and torch (``PYTHONPATH``), and the solve runs on
``GRACKLE_TPU_TORCH_DEVICE`` (default ``cuda``).  A host built against
the float library defines ``GRACKLE_FLOAT_4`` too.  A Fortran host
compiles ``_build/grackle_tpu_fortran.f90`` beside its own sources and
links the (f64) library the same way.

    python -m grackle_tpu_torch.cshim_build [--float]   # prints the path
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sysconfig

from .config import PARAMETER_REGISTRY

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
INCLUDE_DIR = os.path.join(BUILD_DIR, "include")
GEN_SRC_DIR = os.path.join(BUILD_DIR, "src")
LIB_DIR = os.path.join(BUILD_DIR, "clib")
LIBRARY = os.path.join(LIB_DIR, "libgrackle_tpu.so")
FORTRAN_MODULE = os.path.join(BUILD_DIR, "grackle_tpu_fortran.f90")
SOURCES = [os.path.join(CSRC, name) for name in (
    "grackle_tpu_shim.cpp", "params_access.inc", "deprecated_api.inc")]

_CTYPE = {int: "int", float: "double", str: "const char *"}
_FTYPE = {int: "integer(c_int)", float: "real(c_double)",
          str: "type(c_ptr)"}
_GENERATED = "/* generated by grackle_tpu_torch/cshim_build.py; do not edit */"

# grackle_field_data member order (grackle: src/clib/grackle_types.h:36-81)
FIELD_MEMBERS = [
    "density", "HI_density", "HII_density", "HM_density",
    "HeI_density", "HeII_density", "HeIII_density", "H2I_density",
    "H2II_density", "DI_density", "DII_density", "HDI_density",
    "e_density", "metal_density", "dust_density", "internal_energy",
    "x_velocity", "y_velocity", "z_velocity",
    "volumetric_heating_rate", "specific_heating_rate",
    "RT_heating_rate", "RT_HI_ionization_rate",
    "RT_HeI_ionization_rate", "RT_HeII_ionization_rate",
    "RT_H2_dissociation_rate", "H2_self_shielding_length",
    "H2_custom_shielding_factor", "isrf_habing",
]


def _c_literal(ptype, val):
    if ptype is int:
        return str(int(val))
    if ptype is float:
        return repr(float(val))
    return '"%s"' % val


def header_text() -> str:
    """grackle_tpu.h: the parameter struct from the registry, the field,
    units and storage structs, and every entry point."""
    struct_body = "\n".join(
        f"  {_CTYPE[ptype]} {name};"
        for name, (ptype, _) in PARAMETER_REGISTRY.items())
    field_members_c = "\n".join(
        f"  gr_float *{m};" for m in FIELD_MEMBERS
    )

    return f"""/* grackle_tpu C API — generated by grackle_tpu_torch/cshim_build.py; do not edit.
 *
 * The analogue of the reference's public C interface
 * (grackle: src/clib/grackle.h:14-187): the same three structs
 * (chemistry_data parameters, opaque storage, code_units) plus the
 * chemistry field struct, backed by the PyTorch + CUDA port via an embedded
 * CPython bridge (grackle_tpu_torch.cshim_bridge).
 */
#ifndef GRACKLE_TPU_H
#define GRACKLE_TPU_H

#ifdef __cplusplus
extern "C" {{
#endif

#define GRACKLE_TPU_SUCCESS 1
#define GRACKLE_TPU_FAIL 0

#ifdef GRACKLE_FLOAT_4
typedef float gr_float;
#else
typedef double gr_float;
#endif

typedef struct {{
{struct_body}
}} chemistry_data;

/* Opaque storage handle (analogue of chemistry_data_storage). */
typedef struct {{
  long long handle;
}} chemistry_data_storage;

typedef struct {{
  int comoving_coordinates;
  double density_units;
  double length_units;
  double time_units;
  double velocity_units;
  double a_units;
  double a_value;
}} code_units;

typedef struct {{
  int grid_rank;
  int *grid_dimension;
  int *grid_start;
  int *grid_end;
  double grid_dx;
{field_members_c}
}} grackle_field_data;

extern int grackle_verbose;
extern chemistry_data *grackle_data;
extern chemistry_data_storage grackle_rates;

int set_default_chemistry_parameters(chemistry_data *my_chemistry);

int local_initialize_chemistry_data(chemistry_data *my_chemistry,
                                    chemistry_data_storage *my_rates,
                                    code_units *my_units);
int initialize_chemistry_data(code_units *my_units);

int local_solve_chemistry(chemistry_data *my_chemistry,
                          chemistry_data_storage *my_rates,
                          code_units *my_units,
                          grackle_field_data *my_fields,
                          double dt_value);
int solve_chemistry(code_units *my_units,
                    grackle_field_data *my_fields,
                    double dt_value);

int local_calculate_cooling_time(chemistry_data *my_chemistry,
                                 chemistry_data_storage *my_rates,
                                 code_units *my_units,
                                 grackle_field_data *my_fields,
                                 gr_float *cooling_time);
int calculate_cooling_time(code_units *my_units,
                           grackle_field_data *my_fields,
                           gr_float *cooling_time);

int local_calculate_temperature(chemistry_data *my_chemistry,
                                chemistry_data_storage *my_rates,
                                code_units *my_units,
                                grackle_field_data *my_fields,
                                gr_float *temperature);
int calculate_temperature(code_units *my_units,
                          grackle_field_data *my_fields,
                          gr_float *temperature);

int local_calculate_pressure(chemistry_data *my_chemistry,
                             chemistry_data_storage *my_rates,
                             code_units *my_units,
                             grackle_field_data *my_fields,
                             gr_float *pressure);
int calculate_pressure(code_units *my_units,
                       grackle_field_data *my_fields,
                       gr_float *pressure);

int local_calculate_gamma(chemistry_data *my_chemistry,
                          chemistry_data_storage *my_rates,
                          code_units *my_units,
                          grackle_field_data *my_fields,
                          gr_float *my_gamma);
int calculate_gamma(code_units *my_units,
                    grackle_field_data *my_fields,
                    gr_float *my_gamma);

int local_calculate_dust_temperature(chemistry_data *my_chemistry,
                                     chemistry_data_storage *my_rates,
                                     code_units *my_units,
                                     grackle_field_data *my_fields,
                                     gr_float *dust_temperature);
int calculate_dust_temperature(code_units *my_units,
                               grackle_field_data *my_fields,
                               gr_float *dust_temperature);

int local_free_chemistry_data(chemistry_data *my_chemistry,
                              chemistry_data_storage *my_rates);

/* ------------------------------------------------------------------ *
 * Deprecated flat-pointer tier (grackle: src/clib/grackle.h:34-77,
 * 124-183): the pre-field-struct entry points kept for literal drop-in
 * linkage with legacy host codes.  New code should use the local_* /
 * global tiers above.  Implementations pack the flat pointers into a
 * grackle_field_data and forward (clib/src/deprecated_api.inc).
 * ------------------------------------------------------------------ */
#if defined(__GNUC__) || defined(__clang__)
#define GRACKLE_TPU_DEPRECATED __attribute__ ((deprecated))
#else
#define GRACKLE_TPU_DEPRECATED
#endif

chemistry_data _set_default_chemistry_parameters(void);

int _initialize_chemistry_data(chemistry_data *my_chemistry,
                               chemistry_data_storage *my_rates,
                               code_units *my_units);

int _free_chemistry_data(chemistry_data *my_chemistry,
                         chemistry_data_storage *my_rates);

int _solve_chemistry(chemistry_data *my_chemistry,
                     chemistry_data_storage *my_rates,
                     code_units *my_units, double dt_value, double dx_value,
                     int grid_rank, int *grid_dimension,
                     int *grid_start, int *grid_end,
                     gr_float *density, gr_float *internal_energy,
                     gr_float *x_velocity, gr_float *y_velocity,
                     gr_float *z_velocity,
                     gr_float *HI_density, gr_float *HII_density,
                     gr_float *HM_density,
                     gr_float *HeI_density, gr_float *HeII_density,
                     gr_float *HeIII_density,
                     gr_float *H2I_density, gr_float *H2II_density,
                     gr_float *DI_density, gr_float *DII_density,
                     gr_float *HDI_density,
                     gr_float *e_density, gr_float *metal_density,
                     gr_float *dust_density,
                     gr_float *volumetric_heating_rate,
                     gr_float *specific_heating_rate,
                     gr_float *RT_heating_rate,
                     gr_float *RT_HI_ionization_rate,
                     gr_float *RT_HeI_ionization_rate,
                     gr_float *RT_HeII_ionization_rate,
                     gr_float *RT_H2_dissociation_rate,
                     gr_float *H2_self_shielding_length)
    GRACKLE_TPU_DEPRECATED;

int _calculate_cooling_time(chemistry_data *my_chemistry,
                            chemistry_data_storage *my_rates,
                            code_units *my_units,
                            int grid_rank, int *grid_dimension,
                            int *grid_start, int *grid_end,
                            gr_float *density, gr_float *internal_energy,
                            gr_float *x_velocity, gr_float *y_velocity,
                            gr_float *z_velocity,
                            gr_float *HI_density, gr_float *HII_density,
                            gr_float *HM_density,
                            gr_float *HeI_density, gr_float *HeII_density,
                            gr_float *HeIII_density,
                            gr_float *H2I_density, gr_float *H2II_density,
                            gr_float *DI_density, gr_float *DII_density,
                            gr_float *HDI_density,
                            gr_float *e_density, gr_float *metal_density,
                            gr_float *dust_density,
                            gr_float *cooling_time,
                            gr_float *RT_heating_rate,
                            gr_float *volumetric_heating_rate,
                            gr_float *specific_heating_rate)
    GRACKLE_TPU_DEPRECATED;

int _calculate_gamma(chemistry_data *my_chemistry,
                     chemistry_data_storage *my_rates,
                     code_units *my_units,
                     int grid_rank, int *grid_dimension,
                     int *grid_start, int *grid_end,
                     gr_float *density, gr_float *internal_energy,
                     gr_float *HI_density, gr_float *HII_density,
                     gr_float *HM_density,
                     gr_float *HeI_density, gr_float *HeII_density,
                     gr_float *HeIII_density,
                     gr_float *H2I_density, gr_float *H2II_density,
                     gr_float *DI_density, gr_float *DII_density,
                     gr_float *HDI_density,
                     gr_float *e_density, gr_float *metal_density,
                     gr_float *my_gamma)
    GRACKLE_TPU_DEPRECATED;

int _calculate_pressure(chemistry_data *my_chemistry,
                        chemistry_data_storage *my_rates,
                        code_units *my_units,
                        int grid_rank, int *grid_dimension,
                        int *grid_start, int *grid_end,
                        gr_float *density, gr_float *internal_energy,
                        gr_float *HI_density, gr_float *HII_density,
                        gr_float *HM_density,
                        gr_float *HeI_density, gr_float *HeII_density,
                        gr_float *HeIII_density,
                        gr_float *H2I_density, gr_float *H2II_density,
                        gr_float *DI_density, gr_float *DII_density,
                        gr_float *HDI_density,
                        gr_float *e_density, gr_float *metal_density,
                        gr_float *pressure)
    GRACKLE_TPU_DEPRECATED;

int _calculate_temperature(chemistry_data *my_chemistry,
                           chemistry_data_storage *my_rates,
                           code_units *my_units,
                           int grid_rank, int *grid_dimension,
                           int *grid_start, int *grid_end,
                           gr_float *density, gr_float *internal_energy,
                           gr_float *HI_density, gr_float *HII_density,
                           gr_float *HM_density,
                           gr_float *HeI_density, gr_float *HeII_density,
                           gr_float *HeIII_density,
                           gr_float *H2I_density, gr_float *H2II_density,
                           gr_float *DI_density, gr_float *DII_density,
                           gr_float *HDI_density,
                           gr_float *e_density, gr_float *metal_density,
                           gr_float *temperature)
    GRACKLE_TPU_DEPRECATED;

/* Dynamic parameter API (grackle: src/clib/grackle.h:41-50,
 * dynamic_api.c:35-116): string-keyed typed access to chemistry_data
 * fields plus name enumeration for serialization.  NULL on unknown
 * name / index past the end.  String access returns const char ** --
 * parameter strings in this build are immutable literals or
 * caller-owned pointers. */
int *local_chemistry_data_access_int(chemistry_data *my_chemistry,
                                     const char *param_name);
double *local_chemistry_data_access_double(chemistry_data *my_chemistry,
                                           const char *param_name);
const char **local_chemistry_data_access_string(
    chemistry_data *my_chemistry, const char *param_name);
const char *param_name_int(unsigned long i);
const char *param_name_double(unsigned long i);
const char *param_name_string(unsigned long i);

typedef struct {{
  const char *version;
  const char *branch;
  const char *revision;
}} grackle_version;

grackle_version get_grackle_version(void);

/* Units helpers (grackle: src/clib/grackle_units.c:24-42). */
double get_velocity_units(const code_units *my_units);
void set_velocity_units(code_units *my_units);
double get_temperature_units(const code_units *my_units);

#ifdef __cplusplus
}}
#endif

#endif /* GRACKLE_TPU_H */
"""


def marshal_text() -> str:
    """params_marshal.inc: chemistry_data -> the bridge's dict."""
    lines = [_GENERATED]
    for name, (ptype, _) in PARAMETER_REGISTRY.items():
        if ptype is int:
            lines.append(f'  set_item(params, "{name}", '
                         f"PyLong_FromLong(my_chemistry->{name}));")
        elif ptype is float:
            lines.append(f'  set_item(params, "{name}", '
                         f"PyFloat_FromDouble(my_chemistry->{name}));")
        else:
            lines.append(
                f'  set_item(params, "{name}", PyUnicode_FromString('
                f"my_chemistry->{name} ? my_chemistry->{name} : \"\"));")
    return "\n".join(lines) + "\n"


def defaults_text() -> str:
    """params_defaults.inc: set_default_chemistry_parameters' body."""
    return "\n".join([_GENERATED] + [
        f"  my_chemistry->{name} = {_c_literal(ptype, default)};"
        for name, (ptype, default) in PARAMETER_REGISTRY.items()]) + "\n"


def access_text() -> str:
    """The name/type/offset table behind the dynamic parameter API
    (dynamic_api.c:35-44); csrc/params_access.inc holds it."""
    type_code = {int: 0, float: 1, str: 2}
    lines = [
        _GENERATED,
        "typedef struct {",
        "  const char *name;",
        "  int type; /* 0 int, 1 double, 2 string */",
        "  size_t offset;",
        "} gtpu_param_entry;",
        "static const gtpu_param_entry gtpu_param_table[] = {",
    ]
    for name, (ptype, _) in PARAMETER_REGISTRY.items():
        lines.append(f'  {{"{name}", {type_code[ptype]}, '
                     f"offsetof(chemistry_data, {name})}},")
    lines.append("};")
    return "\n".join(lines) + "\n"


_F90_INTERFACES = """\
  interface
     integer(c_int) function set_default_chemistry_parameters( &
          my_chemistry) bind(C, name='set_default_chemistry_parameters')
       import
       type(grackle_tpu_chemistry_data), intent(inout) :: my_chemistry
     end function set_default_chemistry_parameters

     integer(c_int) function local_initialize_chemistry_data( &
          my_chemistry, my_rates, my_units) &
          bind(C, name='local_initialize_chemistry_data')
       import
       type(grackle_tpu_chemistry_data), intent(inout) :: my_chemistry
       type(grackle_tpu_storage), intent(inout) :: my_rates
       type(grackle_tpu_units), intent(inout) :: my_units
     end function local_initialize_chemistry_data

     integer(c_int) function initialize_chemistry_data(my_units) &
          bind(C, name='initialize_chemistry_data')
       import
       type(grackle_tpu_units), intent(inout) :: my_units
     end function initialize_chemistry_data

     integer(c_int) function local_solve_chemistry(my_chemistry, &
          my_rates, my_units, my_fields, dt_value) &
          bind(C, name='local_solve_chemistry')
       import
       type(grackle_tpu_chemistry_data), intent(inout) :: my_chemistry
       type(grackle_tpu_storage), intent(inout) :: my_rates
       type(grackle_tpu_units), intent(inout) :: my_units
       type(grackle_tpu_field_data), intent(inout) :: my_fields
       real(c_double), value :: dt_value
     end function local_solve_chemistry

     integer(c_int) function solve_chemistry(my_units, my_fields, &
          dt_value) bind(C, name='solve_chemistry')
       import
       type(grackle_tpu_units), intent(inout) :: my_units
       type(grackle_tpu_field_data), intent(inout) :: my_fields
       real(c_double), value :: dt_value
     end function solve_chemistry

     integer(c_int) function calculate_cooling_time(my_units, &
          my_fields, cooling_time) bind(C, name='calculate_cooling_time')
       import
       type(grackle_tpu_units), intent(inout) :: my_units
       type(grackle_tpu_field_data), intent(inout) :: my_fields
       type(c_ptr), value :: cooling_time
     end function calculate_cooling_time

     integer(c_int) function calculate_temperature(my_units, &
          my_fields, temperature) bind(C, name='calculate_temperature')
       import
       type(grackle_tpu_units), intent(inout) :: my_units
       type(grackle_tpu_field_data), intent(inout) :: my_fields
       type(c_ptr), value :: temperature
     end function calculate_temperature

     integer(c_int) function calculate_pressure(my_units, &
          my_fields, pressure) bind(C, name='calculate_pressure')
       import
       type(grackle_tpu_units), intent(inout) :: my_units
       type(grackle_tpu_field_data), intent(inout) :: my_fields
       type(c_ptr), value :: pressure
     end function calculate_pressure

     integer(c_int) function calculate_gamma(my_units, &
          my_fields, my_gamma) bind(C, name='calculate_gamma')
       import
       type(grackle_tpu_units), intent(inout) :: my_units
       type(grackle_tpu_field_data), intent(inout) :: my_fields
       type(c_ptr), value :: my_gamma
     end function calculate_gamma

     integer(c_int) function calculate_dust_temperature(my_units, &
          my_fields, dust_temperature) &
          bind(C, name='calculate_dust_temperature')
       import
       type(grackle_tpu_units), intent(inout) :: my_units
       type(grackle_tpu_field_data), intent(inout) :: my_fields
       type(c_ptr), value :: dust_temperature
     end function calculate_dust_temperature

     integer(c_int) function local_free_chemistry_data(my_chemistry, &
          my_rates) bind(C, name='local_free_chemistry_data')
       import
       type(grackle_tpu_chemistry_data), intent(inout) :: my_chemistry
       type(grackle_tpu_storage), intent(inout) :: my_rates
     end function local_free_chemistry_data

     ! units helpers (grackle_fortran_interface.def:147-167)
     real(c_double) function get_velocity_units(my_units) &
          bind(C, name='get_velocity_units')
       import
       type(grackle_tpu_units), intent(in) :: my_units
     end function get_velocity_units

     subroutine set_velocity_units(my_units) &
          bind(C, name='set_velocity_units')
       import
       type(grackle_tpu_units), intent(inout) :: my_units
     end subroutine set_velocity_units

     real(c_double) function get_temperature_units(my_units) &
          bind(C, name='get_temperature_units')
       import
       type(grackle_tpu_units), intent(in) :: my_units
     end function get_temperature_units
  end interface
"""


def fortran_text() -> str:
    """grackle_tpu_fortran.f90: the BIND(C) module for Fortran host codes,
    mirroring the header's structs from the same registry and field list
    (clib/gen_header.py's ``gen_fortran``)."""
    params_body = "\n".join(
        f"     {_FTYPE[ptype]} :: {name}"
        for name, (ptype, _) in PARAMETER_REGISTRY.items())
    field_lines = "\n".join(
        f"     type(c_ptr)    :: {m}" for m in FIELD_MEMBERS)
    return f"""\
!=======================================================================
! Fortran 2003 interface to the grackle_tpu C ABI.
! GENERATED by grackle_tpu_torch/cshim_build.py from the same parameter
! registry and field list as the C header -- do not edit by hand.
!
! The analogue of the reference's Fortran interface
! (grackle: src/clib/grackle_fortran_interface.def:15-243): BIND(C)
! mirror types of chemistry_data / chemistry_data_storage / code_units /
! grackle_field_data plus interfaces to every public entry point, so
! Fortran hydro codes can `use grackle_tpu_fortran` and link against
! libgrackle_tpu.so (build the library with the default FLOAT=8 so
! gr_float is c_double).
!=======================================================================

module grackle_tpu_fortran
  use iso_c_binding
  implicit none

  integer, parameter :: RKIND = c_double   ! build with FLOAT=8
  integer, parameter :: DKIND = c_double

  type, bind(C) :: grackle_tpu_chemistry_data
{params_body}
  end type grackle_tpu_chemistry_data

  type, bind(C) :: grackle_tpu_units
     integer(c_int) :: comoving_coordinates
     real(c_double) :: density_units
     real(c_double) :: length_units
     real(c_double) :: time_units
     real(c_double) :: velocity_units
     real(c_double) :: a_units
     real(c_double) :: a_value
  end type grackle_tpu_units

  type, bind(C) :: grackle_tpu_storage
     integer(c_long_long) :: handle
  end type grackle_tpu_storage

  type, bind(C) :: grackle_tpu_field_data
     integer(c_int) :: grid_rank
     type(c_ptr)    :: grid_dimension
     type(c_ptr)    :: grid_start
     type(c_ptr)    :: grid_end
     real(c_double) :: grid_dx
{field_lines}
  end type grackle_tpu_field_data

{_F90_INTERFACES}
end module grackle_tpu_fortran
"""


def _write_if_changed(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        with open(path) as fh:
            if fh.read() == text:
                return
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def generate() -> str:
    """Write grackle_tpu.h, the two generated includes and the Fortran
    module into ``_build/``; returns the include directory."""
    _write_if_changed(os.path.join(INCLUDE_DIR, "grackle_tpu.h"),
                      header_text())
    _write_if_changed(os.path.join(GEN_SRC_DIR, "params_marshal.inc"),
                      marshal_text())
    _write_if_changed(os.path.join(GEN_SRC_DIR, "params_defaults.inc"),
                      defaults_text())
    _write_if_changed(FORTRAN_MODULE, fortran_text())
    return INCLUDE_DIR


def python_flags():
    """(compile flags, link flags) to embed this interpreter, from
    sysconfig: its include directory, and libpython with an rpath to its
    directory."""
    var = sysconfig.get_config_var
    cflags = ["-I" + sysconfig.get_paths()["include"]]
    libdir = var("LIBDIR")
    ldflags = [f"-L{libdir}", f"-lpython{var('LDVERSION')}",
               f"-Wl,-rpath,{libdir}"]
    for name in ("LIBS", "SYSLIBS"):
        ldflags += (var(name) or "").split()
    return cflags, ldflags


def run_env(device, env=None):
    """The environment a host program linked against the library runs
    with: ``GRACKLE_TPU_TORCH_DEVICE`` set to ``device``, and a
    ``PYTHONPATH`` that lets the embedded interpreter import
    grackle_tpu_torch (from this checkout) and this interpreter's
    packages (torch, numpy), which a virtual environment keeps outside
    the embedded interpreter's default path."""
    env = dict(os.environ if env is None else env)
    paths = [os.path.dirname(_PKG_DIR)]
    for key in ("purelib", "platlib"):
        path = sysconfig.get_paths()[key]
        if path not in paths:
            paths.append(path)
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    env["GRACKLE_TPU_TORCH_DEVICE"] = str(device)
    return env


def library_path(float_bytes=8) -> str:
    """libgrackle_tpu.so of the f64 build, or of the float build in a
    directory of its own."""
    if float_bytes == 8:
        return LIBRARY
    if float_bytes == 4:
        return os.path.join(BUILD_DIR, "clib_float4", "libgrackle_tpu.so")
    raise ValueError(f"gr_float is 4 or 8 bytes, not {float_bytes}")


def build_command(out, float_bytes=8):
    cflags, ldflags = python_flags()
    if float_bytes == 4:
        cflags = ["-DGRACKLE_FLOAT_4", *cflags]
    return ["g++", "-O2", "-fPIC", "-std=c++17", "-Wall", "-shared",
            "-I" + INCLUDE_DIR, "-I" + GEN_SRC_DIR, "-I" + CSRC, *cflags,
            "-o", out, SOURCES[0], *ldflags]


def build(float_bytes=8) -> str:
    """Generate the header, includes and Fortran module, compile
    libgrackle_tpu.so (``gr_float`` of ``float_bytes``) if any input
    changed since its last build, and return its path.  Raises if g++
    fails."""
    library = library_path(float_bytes)
    generate()
    digest = hashlib.sha256()
    for path in SOURCES + [os.path.join(INCLUDE_DIR, "grackle_tpu.h"),
                           os.path.join(GEN_SRC_DIR, "params_marshal.inc"),
                           os.path.join(GEN_SRC_DIR, "params_defaults.inc")]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(build_command(library, float_bytes)).encode())
    stamp = library + ".sha256"
    if os.path.exists(library) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read() == digest.hexdigest():
                return library
    os.makedirs(os.path.dirname(library), exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    cmd = build_command(tmp, float_bytes)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("g++ failed to build libgrackle_tpu.so:\n"
                           + " ".join(cmd) + "\n" + res.stdout + res.stderr)
    os.replace(tmp, library)
    _write_if_changed(stamp, digest.hexdigest())
    return library


if __name__ == "__main__":
    import sys

    print(build(4 if "--float" in sys.argv[1:] else 8))
