// The equilibrium dust temperature of every cell as one CUDA launch.
//
// dust_temp_kernel is grackle_tpu_torch/ops/dust_temp.py calc_tdust_1d
// (calc_tdust_1d_g.F:6-306) for one cell a thread: the initial guess, the
// warm start, the CMB and sublimation branches, Newton with a numeric
// derivative for at most ITMAX steps, the warm-started +-5% bracket checked
// by the balance signs, and bisection for at most BI_ITMAX steps with the
// first step clamped at T_SUBL.  Each thread stops Newton and bisection at
// its own cell's convergence.  The twin sweeps every cell together (in
// blocks, ops/device_loop.py) and freezes a finished cell with a mask, which
// gives the same values: every update is masked, and a cell's first
// bisection step is the sweep's step 0.  That Python function is the
// kernel's plain twin; change them together.  The kernel solves every
// cell: the twin's active-cell mask has no counterpart here (its callers
// pass none).
//
// Numerics: the result equals the twin's on the card bit for bit, in f32
// and f64.  Every add, subtract, multiply and divide is an explicit
// round-to-nearest intrinsic, which the compiler never contracts into an
// FMA, in the twin's order: each rounds as the twin's separate PyTorch op
// does.  Where the twin divides by a Python number (gamma_isrf / RADF /
// KGR1, tdust / 1.5e3), PyTorch multiplies by the number's reciprocal, and
// so does this code; ``1.0 / x`` is PyTorch's reciprocal, a division.
// Python numbers, the rate tables' ISRF heating coefficient among them,
// arrive as doubles and are rounded once to T, as PyTorch rounds them.
// Selects and clamps keep NaN as torch.clamp, torch.minimum and
// torch.maximum do.  pow is CUDA's own, which PyTorch's pow calls (powf
// for float); it is built as PyTorch builds it, with nvcc's default
// -fmad=true.  The CMB temperature is a T value in device memory (an
// element of the call's scalar block, or the derived field's 0-d tensor),
// so a CUDA graph replays with a new a_value.
//
// Build (ops/dust_kernel.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=true -prec-div=true -prec-sqrt=true -ftz=false
//        -shared -Xcompiler -fPIC -o libdust_temp.so dust_temp.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Operand slots; grackle_tpu_torch/ops/dust_kernel.py lists the same names
// in the same order (IN_SLOTS).
enum In { I_tgas, I_nh, I_gasgr, I_isrf, I_tdust_init, N_IN };

}  // namespace

// Threads a CTA, one cell each (ops/dust_kernel.py BLOCK).
constexpr int BLOCK = 128;

// Launch arguments; mirrored field for field by ops/dust_kernel.py
// _DustArgs (a ctypes.Structure).
struct DustArgs {
  long long n;
  double gamma_isrf;               // the ISRF heating coefficient
  const void* trad;                // one T: the CMB temperature
  const void* in[N_IN];            // tdust_init may be null (a cold start)
  void* out;                       // tdust
};

namespace {

// calc_tdust_1d_g.F:58-70 (ops/dust_temp.py)
constexpr double T_SUBL = 1.5e3;
constexpr double RADF = 4.0 * 5.670373e-5;  // 4 sigma_SB
constexpr double KGR1 = 4.0e-4;
constexpr double KGR200 = 16.0;
constexpr double TOL = 1.0e-5;
constexpr double BI_TOL = 1.0e-3;
constexpr double MINPERT = 1.0e-10;
constexpr int ITMAX = 50;
constexpr int BI_ITMAX = 30;
constexpr double PERT_I = 1.0e-3;
constexpr double TINY = 1.0e-20;  // constants.tiny

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
__device__ __forceinline__ double t_pow(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float t_pow(float x, float y) {
  return powf(x, y);
}
__device__ __forceinline__ double t_abs(double x) { return fabs(x); }
__device__ __forceinline__ float t_abs(float x) { return fabsf(x); }

// torch.clamp(a, min=b) and torch.maximum(a, b): NaN in a or b is kept.
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
// torch.clamp(a, max=b) and torch.minimum(a, b), likewise.
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T ldg(const void* p, long long i) {
  return __ldg(static_cast<const T*>(p) + i);
}

// One cell's terms of the grain heating - cooling balance.
template <typename T>
struct Cell {
  T tgas, gas_rate, gamma_isrf, trad4;  // gas_rate = gasgr * nh
};

// dust_temp.py calc_kappa_gr: the selected branch of its selects.
template <typename T>
__device__ T kappa(T t) {
  if (t < T(200)) return mul(T(KGR1), mul(t, t));
  if (t < T(T_SUBL)) return T(KGR200);
  // common.ipow(x, -12): (x^4 * x^8), its reciprocal last
  const T x = mul(t, div(T(1), T(1.5e3)));
  const T x2 = mul(x, x);
  const T x4 = mul(x2, x2);
  const T x8 = mul(x4, x4);
  return tmax(mul(T(KGR200), div(T(1), mul(x4, x8))), T(TINY));
}

// dust_temp.py calc_gr_balance at dust temperature t
template <typename T>
__device__ T balance(const Cell<T>& c, T t) {
  const T t2 = mul(t, t);
  const T rad = mul(mul(T(RADF), kappa(t)), sub(c.trad4, mul(t2, t2)));
  return add(add(c.gamma_isrf, rad), mul(c.gas_rate, sub(c.tgas, t)));
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
dust_temp_kernel(const __grid_constant__ DustArgs a) {
  const long long i = blockIdx.x * (long long)BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const T trad = tmax(*static_cast<const T*>(a.trad), T(1));
  Cell<T> c;
  c.tgas = ldg<T>(a.in[I_tgas], i);
  c.gas_rate = mul(ldg<T>(a.in[I_gasgr], i), ldg<T>(a.in[I_nh], i));
  c.gamma_isrf = mul(ldg<T>(a.in[I_isrf], i), T(a.gamma_isrf));
  c.trad4 = mul(mul(trad, trad), mul(trad, trad));
  const bool warm = a.in[I_tdust_init] != nullptr;
  const T init = warm ? ldg<T>(a.in[I_tdust_init], i) : T(0);

  // initial guess (calc_tdust_1d_g.F:105-130) and the warm start
  T tdust = tmax(t_pow(mul(mul(c.gamma_isrf, div(T(1), T(RADF))),
                           div(T(1), T(KGR1))),
                       T(0.17)),
                 trad);
  if (warm && init > trad && init < T(T_SUBL)) tdust = init;
  const bool done_cold = trad >= c.tgas;  // in equilibrium with the CMB
  if (done_cold) tdust = trad;
  bool newton = !done_cold && !(c.tgas > T(T_SUBL));
  bool bisect = !done_cold;

  // Newton with a numeric derivative (calc_tdust_1d_g.F:134-205)
  T pert = T(PERT_I);
  for (int it = 0; it < ITMAX && newton; ++it) {
    const T tdplus = tmax(mul(add(pert, T(1)), tdust), T(1.0e-3));
    const T sol = balance(c, tdust);
    const T solplus = balance(c, tdplus);
    const T slope = div(sub(solplus, sol), mul(pert, tdust));
    const T tnew = sub(tdust, div(sol, slope));
    pert = tmax(tmin(pert, div(mul(T(0.5), t_abs(sub(tnew, tdust))), tnew)),
                T(MINPERT));
    tdust = tnew;
    const bool negative = tnew < trad;
    const bool converged = t_abs(div(sol, solplus)) < T(TOL);
    if (converged && !negative) bisect = false;
    newton = !negative && !converged;
  }

  // bisection (calc_tdust_1d_g.F:209-261) from [trad, tgas], or from the
  // warm start's +-5% where the balance signs show that it brackets
  T t_low = bisect ? trad : tdust;
  T t_high = c.tgas;
  if (warm && bisect) {
    const T lo = tmax(mul(T(0.95), init), trad);
    const T hi = tmin(c.tgas, mul(T(1.05), init));
    if (init > trad && hi > lo && balance(c, lo) > T(0) &&
        balance(c, hi) < T(0)) {
      t_low = lo;
      t_high = hi;
    }
  }
  for (int it = 0; it < BI_ITMAX && bisect; ++it) {
    T t_mid = mul(T(0.5), add(t_low, t_high));
    if (it == 0) t_mid = tmin(t_mid, T(T_SUBL));
    if (balance(c, t_mid) > T(0)) {
      t_low = t_mid;
    } else {
      t_high = t_mid;
    }
    bisect = !(div(t_abs(sub(t_high, t_low)), t_low) <= T(BI_TOL));
  }
  static_cast<T*>(a.out)[i] = t_low;
}

}  // namespace

extern "C" {

// Slot counts and the argument struct's size, so the Python wrapper can
// check its layout against this build's.
int grackle_dust_layout(int* n_in, int* block) {
  *n_in = N_IN;
  *block = BLOCK;
  return (int)sizeof(DustArgs);
}

// The dust temperature of every cell on `stream`, float (is_double = 0) or
// double operands.  Returns cudaGetLastError() after the launch.
int grackle_dust_temperature(const DustArgs* args, int is_double,
                             void* stream) {
  if (args->n <= 0) return 0;
  const unsigned grid = (unsigned)((args->n + BLOCK - 1) / BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    dust_temp_kernel<double><<<grid, BLOCK, 0, s>>>(*args);
  } else {
    dust_temp_kernel<float><<<grid, BLOCK, 0, s>>>(*args);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
