// The Cloudy table lookups of a subcycle as two CUDA launches.
//
// A new-style Cloudy table (rank 1: T; rank 2: n_H, T; rank 3: n_H, z, T)
// is read by one device function, cloudy_interp, the batched gathers and
// lerps of grackle_tpu_torch/ops/interp.py interpolate_1d, interpolate_2d
// and interpolate_3dz (interpolators_g.F:4-101,186-338) for one cell: the
// index math, the corner loads and the lerp chain stay in registers.  Two
// kernels call it:
//
// - fixed_point_kernel: the damped T <-> mu fixed point of tabulated mode
//   (calc_temp1d_cloudy_g.F:128-224), grackle_tpu_torch/ops/tabulated_temp
//   .py tabulated_temperature with its metal correction at convergence.
//   Each thread iterates its own cell and stops where the cell converges or
//   after TI_MAX steps.  The twin sweeps every cell TI_MAX times (in blocks,
//   ops/device_loop.py) and freezes a converged cell with a mask, which
//   gives the same values.
// - cooling_kernel: the new-style Cloudy cooling and heating
//   (cool1d_cloudy_g.F:98-258), grackle_tpu_torch/ops/cloudy_cool.py
//   cloudy_cooling with its CMB floor, heating (switched off past the last
//   redshift of a rank-3 table) and metallicity scaling.  It writes the edot
//   contribution, which cool1d_multi adds.
//
// Those Python functions are the kernels' plain twins; change them
// together.  One cell a thread, no shared memory: the tables (a rank-3
// table of 25 x 10 x 121 f64 is 242 KB) are read through the read-only
// path and stay in L2.
//
// Numerics: the results equal the twins' on the card bit for bit, in f32
// and f64.  Every add, subtract, multiply and divide is an explicit
// round-to-nearest intrinsic, which the compiler never contracts into an
// FMA, in the twin's order: each rounds as the twin's separate PyTorch op
// does.  Where the twin divides by a Python number, PyTorch multiplies by
// the number's reciprocal, and so does this code (the grid step's
// 1/(dim-1)).  log, log10, pow and floor are CUDA's own functions, which
// PyTorch's kernels call; they are built as PyTorch builds them, with
// nvcc's default -fmad=true (the network kernel's -fmad=false changes how
// CUDA's f64 pow rounds: an ulp in a few cells on the card).  Scalars the
// twin takes as Python floats (Gamma - 1, TemperatureStart, 1/ln 10)
// arrive as doubles and are rounded once to T, as PyTorch rounds a Python
// float.  The call's unit scalars dom, zr, utem and comp2 are T values in
// device memory, elements of the call's scalar block (ops/common.py
// scalar_block), so a CUDA graph replays with a new a_value; each thread
// reads them once and finds the redshift bracket itself, with the
// upper-bound bisection of torch.searchsorted.
//
// Build (ops/cloudy_kernel.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=true -prec-div=true -prec-sqrt=true -ftz=false
//        -shared -Xcompiler -fPIC -o libcloudy_interp.so cloudy_interp.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Operand slots; grackle_tpu_torch/ops/cloudy_kernel.py lists the same
// names in the same order (IN_SLOTS, OUT_SLOTS, SCALAR_SLOTS, DATA_SLOTS).
enum In { I_density, I_metal, I_energy, I_rhoH, I_logtem, I_metallicity,
          N_IN };
enum Out { O_tgas, O_mmw, O_edot, N_OUT };
enum Scalar { S_dom, S_zr, S_utem, S_comp2, N_SCALAR };
enum Data { D_mmw, D_cooling, D_heating, N_DATA };

}  // namespace

// Threads a CTA, one cell each (ops/cloudy_kernel.py BLOCK).
constexpr int BLOCK = 128;

// Launch arguments; mirrored field for field by ops/cloudy_kernel.py
// _CloudyArgs (a ctypes.Structure).
struct CloudyArgs {
  long long n;
  int rank;                        // grid_rank, 1..3
  int dim[3];                      // grid_dimension (rank entries)
  int ti_max;                      // fixed point: most steps a cell takes
  int imetal;                      // fixed point: the metal correction
  int icmbTfloor;                  // cooling: the CMB temperature floor
  int iClHeat;                     // cooling: heating (a table is given)
  int iZscale;                     // cooling: scaled by the metallicity
  double gamma_m1;                 // Gamma - 1
  double temstart;                 // TemperatureStart
  double inv_log10;                // 1 / ln 10
  const void* par[3];              // the grid's axes, par1..par3
  const void* data[N_DATA];        // mmw; cooling, heating
  const void* scalar[N_SCALAR];    // dom, zr, utem, comp2 (one T each)
  const void* in[N_IN];
  void* out[N_OUT];
};

namespace {

// mean molecular weight of the metals (calc_temp1d_cloudy_g.F:214-224)
constexpr double MU_METAL = 16.0;
// |mu step / mu - 1| at which a cell has converged
// (calc_temp1d_cloudy_g.F:199)
constexpr double MU_TOLERANCE = 1.0e-2;

// Round-to-nearest arithmetic, never contracted into an FMA.
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double div(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}

// CUDA's functions, which PyTorch's kernels call for each type.
__device__ __forceinline__ double t_log(double x) { return log(x); }
__device__ __forceinline__ float t_log(float x) { return logf(x); }
__device__ __forceinline__ double t_log10(double x) { return log10(x); }
__device__ __forceinline__ float t_log10(float x) { return log10f(x); }
__device__ __forceinline__ double t_pow10(double x) { return pow(10.0, x); }
__device__ __forceinline__ float t_pow10(float x) { return powf(10.0f, x); }
__device__ __forceinline__ double t_floor(double x) { return floor(x); }
__device__ __forceinline__ float t_floor(float x) { return floorf(x); }

// NaN-propagating max, as torch.clamp(min=).
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T tabs(T a) {
  return a < T(0) ? -a : (a == T(0) ? T(0) : a);
}

template <typename T>
__device__ __forceinline__ T ldg(const T* p, long long i) {
  return __ldg(p + i);
}

__device__ __forceinline__ long long clamp_index(long long i, long long hi) {
  i = i > 0 ? i : 0;
  return i < hi ? i : hi;
}

// One uniform axis of the grid: its values and the step
// (par[dim-1] - par[0]) / (dim - 1), formed as PyTorch forms it.
template <typename T>
struct Axis {
  const T* par;
  int dim;
  T step;
};

template <typename T>
__device__ __forceinline__ Axis<T> make_axis(const void* par, int dim) {
  const T* p = static_cast<const T*>(par);
  return Axis<T>{p, dim,
                 mul(sub(ldg(p, dim - 1), ldg(p, 0)),
                     div(T(1), T(dim - 1)))};
}

// 0-based lower corner on a uniform axis, clipped to [0, dim-2]
// (interp.py _uniform_index; interpolators_g.F:29-30): values past the
// grid's edges extrapolate from the edge cell.
template <typename T>
__device__ __forceinline__ long long corner(const Axis<T>& a, T x) {
  const long long i = static_cast<long long>(
      t_floor(div(sub(x, ldg(a.par, 0)), a.step)));
  return clamp_index(i, a.dim - 2);
}

// interp.py _lerp
template <typename T>
__device__ __forceinline__ T lerp(T x, T x0, T x1, T f0, T f1) {
  return add(mul(sub(x, x0), div(sub(f1, f0), sub(x1, x0))), f0);
}

// A table's grid for one call: the axes and, for rank 3, the redshift
// bracket of the call's zr (interp.py redshift_index) with the log(1+z)
// weights of interpolate_3dz.
template <typename T>
struct Grid {
  int rank;
  Axis<T> n_h, temp;  // n_h unused at rank 1
  int d2;             // redshifts (rank 3)
  long long zi;       // lower redshift of the 3-D path, in [0, d2-2]
  long long zlast;    // the slice of the 2-D path past the last redshift
  bool end_int;       // zr at or past the second-to-last redshift
  T zlog, zfrac;
};

template <typename T>
__device__ Grid<T> make_grid(const CloudyArgs& a, T zr) {
  Grid<T> g{};
  g.rank = a.rank;
  if (a.rank == 1) {
    g.temp = make_axis<T>(a.par[0], a.dim[0]);
    return g;
  }
  g.n_h = make_axis<T>(a.par[0], a.dim[0]);
  if (a.rank == 2) {
    g.temp = make_axis<T>(a.par[1], a.dim[1]);
    return g;
  }
  g.temp = make_axis<T>(a.par[2], a.dim[2]);
  const T* par2 = static_cast<const T*>(a.par[1]);
  const int d2 = g.d2 = a.dim[1];
  // torch.searchsorted(par2, zr, right=True) as PyTorch's CUDA upper bound
  long long start = 0, end = d2;
  while (start < end) {
    const long long mid = start + ((end - start) >> 1);
    if (!(ldg(par2, mid) > zr)) {
      start = mid + 1;
    } else {
      end = mid;
    }
  }
  long long zi0 = start - 1;
  zi0 = zi0 > 0 ? zi0 : 0;
  zi0 = zi0 < d2 - 3 ? zi0 : d2 - 3;
  g.end_int = zr >= ldg(par2, d2 - 2);
  if (g.end_int) zi0 = d2 - 1;
  g.zi = clamp_index(zi0, d2 - 2);
  g.zlast = clamp_index(zi0, d2 - 1);
  const T p_lo = ldg(par2, g.zi);
  g.zlog = t_log(div(add(ldg(par2, g.zi + 1), T(1)), add(p_lo, T(1))));
  g.zfrac = t_log(div(add(zr, T(1)), add(p_lo, T(1))));
  return g;
}

// The table ``data`` at log10 n_H ``x_n`` and log10 T ``x_t``:
// interp.py interpolate_1d (rank 1), interpolate_2d (rank 2) and
// interpolate_3dz (rank 3), operation for operation.
template <typename T>
__device__ T cloudy_interp(const Grid<T>& g, const T* data, T x_n, T x_t) {
  const Axis<T>& at = g.temp;
  const long long it = corner(at, x_t);
  const T t0 = ldg(at.par, it), t1 = ldg(at.par, it + 1);
  if (g.rank == 1) {
    return lerp(x_t, t0, t1, ldg(data, it), ldg(data, it + 1));
  }
  const Axis<T>& an = g.n_h;
  const long long jn = corner(an, x_n);
  const T n0 = ldg(an.par, jn), n1 = ldg(an.par, jn + 1);
  // the lerp along T of the row at n_H corner jn + q and redshift slice z
  auto row = [&](long long q, long long z) {
    const long long base =
        ((jn + q) * (g.rank == 3 ? g.d2 : 1) + z) * at.dim + it;
    return lerp(x_t, t0, t1, ldg(data, base), ldg(data, base + 1));
  };
  if (g.rank == 2) {
    return lerp(x_n, n0, n1, row(0, 0), row(1, 0));
  }
  if (g.end_int) {
    // the 2-D fallback at the last redshift slice
    return lerp(x_n, n0, n1, row(0, g.zlast), row(1, g.zlast));
  }
  T v[2];
  for (int q = 0; q < 2; ++q) {
    const T lo = row(q, g.zi);
    v[q] = add(mul(g.zfrac, div(sub(row(q, g.zi + 1), lo), g.zlog)), lo);
  }
  return lerp(x_n, n0, n1, v[0], v[1]);
}

template <typename T>
__device__ __forceinline__ T scalar(const CloudyArgs& a, int slot) {
  return *static_cast<const T*>(a.scalar[slot]);
}

template <typename T>
__device__ __forceinline__ T in(const CloudyArgs& a, long long i, int slot) {
  return ldg(static_cast<const T*>(a.in[slot]), i);
}

template <typename T>
__device__ __forceinline__ void put(const CloudyArgs& a, long long i,
                                    int slot, T v) {
  T* __restrict__ out = static_cast<T*>(a.out[slot]);
  out[i] = v;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
fixed_point_kernel(const __grid_constant__ CloudyArgs a) {
  const long long i = blockIdx.x * (long long)BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const Grid<T> g = make_grid<T>(a, scalar<T>(a, S_zr));
  const T* mmw = static_cast<const T*>(a.data[D_mmw]);
  const T utem = scalar<T>(a, S_utem);
  const T g1 = T(a.gamma_m1), tstart = T(a.temstart);
  const T inv_log10 = T(a.inv_log10);
  const T e = in<T>(a, i, I_energy);
  const T log_n_h = t_log10(mul(in<T>(a, i, I_rhoH), scalar<T>(a, S_dom)));

  T munew = T(1), tgas = T(0);
  bool done = false;
  for (int step = 0; step < a.ti_max && !done; ++step) {
    const T muold = munew;
    T tgas_i = tmax(mul(mul(mul(g1, e), munew), utem), tstart);
    const T log10tem = mul(t_log(tgas_i), inv_log10);
    const T mu = mul(T(0.5),
                     add(cloudy_interp(g, mmw, log_n_h, log10tem), muold));
    tgas_i = div(mul(tgas_i, mu), muold);
    done = tabs(sub(div(mu, muold), T(1))) <= T(MU_TOLERANCE);
    munew = mu;
    tgas = tgas_i;
  }
  // the metal correction at convergence; an unconverged cell keeps its mu
  if (a.imetal && done) {
    const T d = in<T>(a, i, I_density), metal = in<T>(a, i, I_metal);
    const T mu_corr = div(d, add(div(sub(d, metal), munew),
                                 mul(metal, div(T(1), T(MU_METAL)))));
    tgas = div(mul(tgas, mu_corr), munew);
    munew = mu_corr;
  }
  put(a, i, O_tgas, tgas);
  put(a, i, O_mmw, munew);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
cooling_kernel(const __grid_constant__ CloudyArgs a) {
  const long long i = blockIdx.x * (long long)BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const Grid<T> g = make_grid<T>(a, scalar<T>(a, S_zr));
  const T* cool = static_cast<const T*>(a.data[D_cooling]);
  const T rhoH = in<T>(a, i, I_rhoH);
  const T log10tem = mul(in<T>(a, i, I_logtem), T(a.inv_log10));
  const T log_n_h = t_log10(mul(rhoH, scalar<T>(a, S_dom)));

  T edot = -t_pow10(cloudy_interp(g, cool, log_n_h, log10tem));
  if (a.icmbTfloor) {
    const T log10_tcmb = t_log10(scalar<T>(a, S_comp2));
    if (sub(log10tem, log10_tcmb) < T(2)) {
      edot = add(edot, t_pow10(cloudy_interp(g, cool, log_n_h,
                                                log10_tcmb)));
    }
  }
  if (a.iClHeat) {
    // no heating past the last redshift of a rank-3 table
    // (cool1d_cloudy_g.F:136-137); the twin adds a zero there
    const T heat = g.rank == 3 && g.end_int
        ? T(0)
        : t_pow10(cloudy_interp(g, static_cast<const T*>(
                                          a.data[D_heating]),
                                   log_n_h, log10tem));
    edot = add(edot, heat);
  }
  if (a.iZscale) edot = mul(edot, in<T>(a, i, I_metallicity));
  put(a, i, O_edot, mul(mul(edot, rhoH), rhoH));
}

int launch(bool fixed_point, const CloudyArgs* args, int is_double,
           void* stream) {
  if (args->n <= 0) return 0;
  const unsigned grid = (unsigned)((args->n + BLOCK - 1) / BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed_point && is_double) {
    fixed_point_kernel<double><<<grid, BLOCK, 0, s>>>(*args);
  } else if (fixed_point) {
    fixed_point_kernel<float><<<grid, BLOCK, 0, s>>>(*args);
  } else if (is_double) {
    cooling_kernel<double><<<grid, BLOCK, 0, s>>>(*args);
  } else {
    cooling_kernel<float><<<grid, BLOCK, 0, s>>>(*args);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Slot counts and the argument struct's size, so the Python wrapper can
// check its layout against this build's.
int grackle_cloudy_layout(int* n_in, int* n_out, int* n_scalar,
                          int* n_data, int* block) {
  *n_in = N_IN;
  *n_out = N_OUT;
  *n_scalar = N_SCALAR;
  *n_data = N_DATA;
  *block = BLOCK;
  return (int)sizeof(CloudyArgs);
}

// The fixed point of every cell on `stream`, float (is_double = 0) or
// double operands.  Returns cudaGetLastError() after the launch.
int grackle_cloudy_fixed_point(const CloudyArgs* args, int is_double,
                               void* stream) {
  return launch(true, args, is_double, stream);
}

// The Cloudy cooling of every cell on `stream`, as above.
int grackle_cloudy_cooling(const CloudyArgs* args, int is_double,
                           void* stream) {
  return launch(false, args, is_double, stream);
}

}  // extern "C"
