/* grackle_tpu C ABI shim on the PyTorch + CUDA port.
 *
 * The port's copy of clib/src/grackle_tpu_shim.cpp: the same C API
 * (grackle_tpu.h, the analogue of the reference's grackle.h +
 * solve_chemistry.c etc.) for host hydro codes in C/C++, dispatching to
 * grackle_tpu_torch through an embedded CPython interpreter and the
 * grackle_tpu_torch.cshim_bridge module.  Field arrays cross the boundary
 * zero-copy (the bridge wraps the caller's pointers with NumPy views,
 * solves on the device GRACKLE_TPU_TORCH_DEVICE names, default cuda, and
 * writes the results back in place).  Built by
 * grackle_tpu_torch/cshim_build.py into grackle_tpu_torch/_build/clib/.
 */

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>

#include "grackle_tpu.h"

int grackle_verbose = 0;
chemistry_data *grackle_data = nullptr;
chemistry_data_storage grackle_rates = {0};  /* grackle.h:22 global tier */

static std::mutex g_mutex;

namespace {

void set_item(PyObject *dict, const char *key, PyObject *val) {
  /* steals val */
  if (val == nullptr) {
    return;
  }
  PyDict_SetItemString(dict, key, val);
  Py_DECREF(val);
}

bool ensure_python() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    if (Py_IsInitialized()) {
      /* Release the GIL held by Py_InitializeEx so that any host
       * thread (not just the one that triggered initialization) can
       * later acquire it with PyGILState_Ensure — host codes may call
       * the API from OpenMP/pthread workers (the reference is likewise
       * callable from threaded hydro codes; see
       * grackle: src/example/cxx_omp_example.C). */
      (void)PyEval_SaveThread();
    }
  }
  return Py_IsInitialized();
}

/* RAII GIL acquisition for the calling host thread.  Every API entry
 * point takes g_mutex first (serializing bridge calls) and then the
 * GIL; calls are safe from any thread. */
class GilGuard {
 public:
  GilGuard() : state_(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state_); }
  GilGuard(const GilGuard &) = delete;
  GilGuard &operator=(const GilGuard &) = delete;

 private:
  PyGILState_STATE state_;
};

PyObject *bridge_module() {
  static PyObject *mod = nullptr;
  if (mod == nullptr) {
    mod = PyImport_ImportModule("grackle_tpu_torch.cshim_bridge");
    if (mod == nullptr) {
      PyErr_Print();
      std::fprintf(stderr,
                   "grackle_tpu: failed to import "
                   "grackle_tpu_torch.cshim_bridge (are grackle_tpu_torch "
                   "and torch on PYTHONPATH?)\n");
    }
  }
  return mod;
}

PyObject *params_dict(const chemistry_data *my_chemistry) {
  PyObject *params = PyDict_New();
#include "params_marshal.inc"
  return params;
}

PyObject *units_dict(const code_units *my_units) {
  PyObject *u = PyDict_New();
  set_item(u, "comoving_coordinates",
           PyLong_FromLong(my_units->comoving_coordinates));
  set_item(u, "density_units",
           PyFloat_FromDouble(my_units->density_units));
  set_item(u, "length_units",
           PyFloat_FromDouble(my_units->length_units));
  set_item(u, "time_units", PyFloat_FromDouble(my_units->time_units));
  set_item(u, "a_units", PyFloat_FromDouble(my_units->a_units));
  set_item(u, "a_value", PyFloat_FromDouble(my_units->a_value));
  return u;
}

PyObject *grid_dict(const grackle_field_data *f) {
  PyObject *g = PyDict_New();
  set_item(g, "grid_rank", PyLong_FromLong(f->grid_rank));
  PyObject *dims = PyList_New(f->grid_rank);
  PyObject *start = PyList_New(f->grid_rank);
  PyObject *end = PyList_New(f->grid_rank);
  for (int i = 0; i < f->grid_rank; i++) {
    PyList_SetItem(dims, i, PyLong_FromLong(f->grid_dimension[i]));
    PyList_SetItem(start, i, PyLong_FromLong(f->grid_start[i]));
    PyList_SetItem(end, i, PyLong_FromLong(f->grid_end[i]));
  }
  PyDict_SetItemString(g, "grid_dimension", dims);
  Py_DECREF(dims);
  PyDict_SetItemString(g, "grid_start", start);
  Py_DECREF(start);
  PyDict_SetItemString(g, "grid_end", end);
  Py_DECREF(end);
  set_item(g, "grid_dx", PyFloat_FromDouble(f->grid_dx));
  return g;
}

void add_ptr(PyObject *dict, const char *name, const gr_float *ptr) {
  if (ptr != nullptr) {
    set_item(dict, name, PyLong_FromVoidPtr(const_cast<gr_float *>(ptr)));
  }
}

PyObject *fields_dict(const grackle_field_data *f) {
  PyObject *d = PyDict_New();
  add_ptr(d, "density", f->density);
  add_ptr(d, "internal_energy", f->internal_energy);
  add_ptr(d, "x_velocity", f->x_velocity);
  add_ptr(d, "y_velocity", f->y_velocity);
  add_ptr(d, "z_velocity", f->z_velocity);
  add_ptr(d, "e_density", f->e_density);
  add_ptr(d, "HI_density", f->HI_density);
  add_ptr(d, "HII_density", f->HII_density);
  add_ptr(d, "HM_density", f->HM_density);
  add_ptr(d, "HeI_density", f->HeI_density);
  add_ptr(d, "HeII_density", f->HeII_density);
  add_ptr(d, "HeIII_density", f->HeIII_density);
  add_ptr(d, "H2I_density", f->H2I_density);
  add_ptr(d, "H2II_density", f->H2II_density);
  add_ptr(d, "DI_density", f->DI_density);
  add_ptr(d, "DII_density", f->DII_density);
  add_ptr(d, "HDI_density", f->HDI_density);
  add_ptr(d, "metal_density", f->metal_density);
  add_ptr(d, "dust_density", f->dust_density);
  add_ptr(d, "volumetric_heating_rate", f->volumetric_heating_rate);
  add_ptr(d, "specific_heating_rate", f->specific_heating_rate);
  add_ptr(d, "RT_heating_rate", f->RT_heating_rate);
  add_ptr(d, "RT_HI_ionization_rate", f->RT_HI_ionization_rate);
  add_ptr(d, "RT_HeI_ionization_rate", f->RT_HeI_ionization_rate);
  add_ptr(d, "RT_HeII_ionization_rate", f->RT_HeII_ionization_rate);
  add_ptr(d, "RT_H2_dissociation_rate", f->RT_H2_dissociation_rate);
  add_ptr(d, "H2_self_shielding_length", f->H2_self_shielding_length);
  add_ptr(d, "H2_custom_shielding_factor",
          f->H2_custom_shielding_factor);
  add_ptr(d, "isrf_habing", f->isrf_habing);
  return d;
}

long call_bridge_solve(long long handle, const code_units *my_units,
                       const grackle_field_data *my_fields,
                       double dt_value) {
  PyObject *mod = bridge_module();
  if (mod == nullptr) return 0;
  PyObject *units = units_dict(my_units);
  PyObject *grid = grid_dict(my_fields);
  PyObject *fields = fields_dict(my_fields);
  PyObject *res = PyObject_CallMethod(
      mod, "solve_chemistry", "LOOOdi", handle, units, grid, fields,
      dt_value, (int)sizeof(gr_float));
  Py_DECREF(units);
  Py_DECREF(grid);
  Py_DECREF(fields);
  if (res == nullptr) {
    PyErr_Print();
    return 0;
  }
  long rv = PyLong_AsLong(res);
  Py_DECREF(res);
  return rv;
}

long call_bridge_calculate(const char *which, long long handle,
                           const code_units *my_units,
                           const grackle_field_data *my_fields,
                           gr_float *out) {
  PyObject *mod = bridge_module();
  if (mod == nullptr) return 0;
  PyObject *units = units_dict(my_units);
  PyObject *grid = grid_dict(my_fields);
  PyObject *fields = fields_dict(my_fields);
  PyObject *res = PyObject_CallMethod(
      mod, which, "LOOOLi", handle, units, grid, fields,
      (long long)(intptr_t)out, (int)sizeof(gr_float));
  Py_DECREF(units);
  Py_DECREF(grid);
  Py_DECREF(fields);
  if (res == nullptr) {
    PyErr_Print();
    return 0;
  }
  long rv = PyLong_AsLong(res);
  Py_DECREF(res);
  return rv;
}

}  // namespace

extern "C" {

int set_default_chemistry_parameters(chemistry_data *my_chemistry) {
#include "params_defaults.inc"
  grackle_data = my_chemistry;
  return GRACKLE_TPU_SUCCESS;
}

int local_initialize_chemistry_data(chemistry_data *my_chemistry,
                                    chemistry_data_storage *my_rates,
                                    code_units *my_units) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!ensure_python()) return GRACKLE_TPU_FAIL;
  GilGuard gil;
  PyObject *mod = bridge_module();
  if (mod == nullptr) return GRACKLE_TPU_FAIL;
  PyObject *params = params_dict(my_chemistry);
  PyObject *units = units_dict(my_units);
  PyObject *res = PyObject_CallMethod(
      mod, "initialize_context", "OO", params, units);
  Py_DECREF(params);
  Py_DECREF(units);
  if (res == nullptr) {
    PyErr_Print();
    return GRACKLE_TPU_FAIL;
  }
  long long handle = PyLong_AsLongLong(res);
  Py_DECREF(res);
  if (handle < 0) return GRACKLE_TPU_FAIL;
  my_rates->handle = handle;
  return GRACKLE_TPU_SUCCESS;
}

int initialize_chemistry_data(code_units *my_units) {
  if (grackle_data == nullptr) return GRACKLE_TPU_FAIL;
  return local_initialize_chemistry_data(
      grackle_data, &grackle_rates, my_units);
}

int local_solve_chemistry(chemistry_data *my_chemistry,
                          chemistry_data_storage *my_rates,
                          code_units *my_units,
                          grackle_field_data *my_fields,
                          double dt_value) {
  (void)my_chemistry;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!ensure_python()) return GRACKLE_TPU_FAIL;
  GilGuard gil;
  return call_bridge_solve(my_rates->handle, my_units, my_fields,
                           dt_value)
             ? GRACKLE_TPU_SUCCESS
             : GRACKLE_TPU_FAIL;
}

int solve_chemistry(code_units *my_units, grackle_field_data *my_fields,
                    double dt_value) {
  return local_solve_chemistry(grackle_data, &grackle_rates,
                               my_units, my_fields, dt_value);
}

#define CALC_IMPL(name)                                                   \
  int local_calculate_##name(                                             \
      chemistry_data *my_chemistry, chemistry_data_storage *my_rates,    \
      code_units *my_units, grackle_field_data *my_fields,               \
      gr_float *out) {                                                    \
    (void)my_chemistry;                                                   \
    std::lock_guard<std::mutex> lock(g_mutex);                            \
    if (!ensure_python()) return GRACKLE_TPU_FAIL;                         \
    GilGuard gil;                                                          \
    return call_bridge_calculate("calculate_" #name, my_rates->handle,   \
                                 my_units, my_fields, out)                \
               ? GRACKLE_TPU_SUCCESS                                      \
               : GRACKLE_TPU_FAIL;                                        \
  }                                                                       \
  int calculate_##name(code_units *my_units,                              \
                       grackle_field_data *my_fields, gr_float *out) {    \
    return local_calculate_##name(grackle_data, &grackle_rates,   \
                                  my_units, my_fields, out);              \
  }

CALC_IMPL(cooling_time)
CALC_IMPL(temperature)
CALC_IMPL(pressure)
CALC_IMPL(gamma)
CALC_IMPL(dust_temperature)

#undef CALC_IMPL

/* --- dynamic parameter API (grackle: src/clib/dynamic_api.c:35-116):
 * string-keyed typed field access over the generated name/type/offset
 * table (the analogue of the reference's X-macro offsetof table), plus
 * per-type name enumeration for serialization. --- */

#include <cstddef>
#include "params_access.inc"

static void *param_lookup(chemistry_data *my_chemistry,
                          const char *param_name, int type) {
  if (my_chemistry == nullptr || param_name == nullptr) return nullptr;
  const size_t n = sizeof(gtpu_param_table) / sizeof(gtpu_param_table[0]);
  for (size_t i = 0; i < n; i++) {
    if (gtpu_param_table[i].type == type &&
        std::strcmp(gtpu_param_table[i].name, param_name) == 0) {
      return reinterpret_cast<char *>(my_chemistry) +
             gtpu_param_table[i].offset;
    }
  }
  return nullptr;
}

static const char *param_name_by_type(int type, unsigned long i) {
  const size_t n = sizeof(gtpu_param_table) / sizeof(gtpu_param_table[0]);
  unsigned long seen = 0;
  for (size_t j = 0; j < n; j++) {
    if (gtpu_param_table[j].type == type) {
      if (seen == i) return gtpu_param_table[j].name;
      seen++;
    }
  }
  return nullptr;
}

int *local_chemistry_data_access_int(chemistry_data *my_chemistry,
                                     const char *param_name) {
  return static_cast<int *>(param_lookup(my_chemistry, param_name, 0));
}

double *local_chemistry_data_access_double(chemistry_data *my_chemistry,
                                           const char *param_name) {
  return static_cast<double *>(param_lookup(my_chemistry, param_name, 1));
}

const char **local_chemistry_data_access_string(
    chemistry_data *my_chemistry, const char *param_name) {
  return static_cast<const char **>(
      param_lookup(my_chemistry, param_name, 2));
}

const char *param_name_int(unsigned long i) {
  return param_name_by_type(0, i);
}

const char *param_name_double(unsigned long i) {
  return param_name_by_type(1, i);
}

const char *param_name_string(unsigned long i) {
  return param_name_by_type(2, i);
}

int local_free_chemistry_data(chemistry_data *my_chemistry,
                              chemistry_data_storage *my_rates) {
  (void)my_chemistry;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!ensure_python()) return GRACKLE_TPU_FAIL;
  GilGuard gil;
  PyObject *mod = bridge_module();
  if (mod == nullptr) return GRACKLE_TPU_FAIL;
  PyObject *res = PyObject_CallMethod(mod, "free_context", "L",
                                      my_rates->handle);
  Py_XDECREF(res);
  my_rates->handle = 0;
  return GRACKLE_TPU_SUCCESS;
}

/* Units helpers (grackle: src/clib/grackle_units.c:24-42); pure C,
 * same formulas as grackle_tpu_torch.units. */

double get_velocity_units(const code_units *my_units) {
  double velocity_units = my_units->length_units / my_units->time_units;
  if (my_units->comoving_coordinates == 1) {
    velocity_units /= my_units->a_value;
  }
  return velocity_units;
}

void set_velocity_units(code_units *my_units) {
  my_units->velocity_units = get_velocity_units(my_units);
}

double get_temperature_units(const code_units *my_units) {
  const double mh = 1.67262171e-24;     /* phys_constants.h */
  const double kboltz = 1.3806504e-16;
  double v = get_velocity_units(my_units);
  return mh * v * v / kboltz;
}

grackle_version get_grackle_version(void) {
  grackle_version v;
  v.version = "0.1.0";
  v.branch = "main";
  v.revision = "";
  return v;
}

}  // extern "C"

/* Deprecated flat-pointer API tier (grackle.h:34-77 analogue). */
#include "deprecated_api.inc"
