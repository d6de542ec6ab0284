// The rate lookup of a subcycle and its H2-equilibrium limit as one CUDA
// launch.
//
// rates_kernel is, for one cell a thread, grackle_tpu_torch/ops/
// chemistry_step.py lookup_cool_rates (solve_rate_cool_g.F:1079-1737)
// followed by its h2_equilibrium_limit (solve_rate_cool_g.F:592-643): the log-temperature table index, the gather and lerp of every
// rate the configuration's network reads, the bilinear (T, T_dust) h2dust,
// the radiation shields k24-k31 (the radiative-transfer H2 dissociation,
// the Wolcott-Green & Haiman 2019 H2 factor for H2_self_shielding 1 to 3,
// H2_custom_shielding, the Rahmati et al. 2013 factors for
// self_shielding_method 1 to 3), the density-dependent k13 from the 14
// k13dd coefficients, and the H2-equilibrium dt limit with its select.
// Those Python functions are the kernel's plain twin; change them together.
// The configuration's flags ride in the argument struct and are uniform
// across a launch, so the branches do not diverge.
//
// It replaces no TPU kernel: the JAX package computes these with XLA
// gathers and elementwise ops.  Replayed in a CUDA graph, the twin is
// about 370 nodes a subcycle at chemistry 3 (about 400 at chemistry 2),
// each a launch that moves a few arrays; here the table index never
// leaves registers and each cell's inputs are read once.  What bounds the
// kernel is its per-cell traffic: the inputs its options read (7 and the
// mask at chemistry 3 with dust and no shielding, 13 and the mask at
// chemistry 2 with both shieldings) and up to 41 rows written, 8 B each in
// f64: 385 B a cell at chemistry 3, 0.0094 ms at 81,920 cells and 0.12 ms
// at 1,048,576 at 3.35 TB/s.  The tables (the 32 rates of
// 600 bins, k13dd and h2dust: a few hundred kB in f64) are read through
// the read-only path and stay in L1 and L2, so they are not counted.  The
// rows are written one after another, each coalesced across a warp.
//
// Numerics: the results equal the twin's on the card bit for bit, in f32
// and f64.  Every add, subtract, multiply and divide is an explicit
// round-to-nearest intrinsic, which the compiler never contracts into an
// FMA, in the twin's order: each rounds as the twin's separate PyTorch op
// does.  Where the twin divides by a Python number, PyTorch multiplies by
// the number's reciprocal, and so does this code; ``c / x`` with a Python
// number c is PyTorch's reciprocal of x (a division) times c.  The bin
// edges t1, t2 stay f64 whatever T is, as the twin keeps them, and round
// to T where they meet a T value.  Python numbers arrive as doubles and
// are rounded once to T, as PyTorch rounds a Python float.  Clamps,
// minimum and maximum keep NaN as PyTorch's do.  log, log10, exp, sqrt and
// pow are CUDA's own, which PyTorch's kernels call; they are built as
// PyTorch builds them, with nvcc's default -fmad=true.  The photo rates
// and unit scalars are T values in device memory, elements of the call's
// scalar block (ops/common.py scalar_block), so a CUDA graph replays with
// a new a_value and new photo rates.
//
// Build (ops/rates_kernel.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=true -prec-div=true -prec-sqrt=true -ftz=false
//        -shared -Xcompiler -fPIC -o librate_lookup.so rate_lookup.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Operand slots; grackle_tpu_torch/ops/rates_kernel.py lists the same
// names in the same order (IN_SLOTS, SCALAR_SLOTS, TABLE_SLOTS).
enum In { I_tgas, I_mmw, I_tdust, I_dust2gas, I_density, I_HI, I_HII,
          I_HeI, I_HeII, I_HeIII, I_HM, I_H2I, I_H2II, I_DI, I_DII, I_HDI,
          I_RT_H2_dissociation_rate, I_H2_self_shielding_length,
          I_l_h2shield_field, I_H2_custom_shielding_factor, I_edot, I_p2d,
          I_itmask, N_IN };
enum Scalar { S_k24, S_k25, S_k26, S_k28, S_k29, S_k30, S_k31, S_crsHI,
              S_crsHeI, S_dom, S_tbase1, S_c_ljeans, S_xbase1, N_SCALAR };
enum Table { T_k1, T_k2, T_k3, T_k4, T_k5, T_k6, T_k57, T_k58, T_k7, T_k8,
             T_k9, T_k10, T_k11, T_k12, T_k13, T_k14, T_k15, T_k16, T_k17,
             T_k18, T_k19, T_k22, T_n_cr_n, T_n_cr_d1, T_n_cr_d2, T_k50,
             T_k51, T_k52, T_k53, T_k54, T_k55, T_k56, T_k13dd, T_h2dust,
             N_TABLE };

}  // namespace

// Threads a CTA, one cell each (ops/rates_kernel.py BLOCK).
constexpr int BLOCK = 128;

// Launch arguments; mirrored field for field by ops/rates_kernel.py
// _RatesArgs (a ctypes.Structure).
struct RatesArgs {
  long long n;
  int ispecies;                    // primordial_chemistry, 1..3
  int anydust;                     // h2_on_dust or dust_chemistry
  int three_body_rate;
  int h2_self_shielding;
  int h2_custom_shielding;
  int self_shielding_method;
  int rt;                          // use_radiative_transfer == 1
  int n_bins;                      // NumberOfTemperatureBins
  int n_dust_bins;                 // NumberOfDustTemperatureBins
  double logt0;                    // log TemperatureStart
  double logt9;                    // log TemperatureEnd
  double dlogt;                    // the bin width in log T
  double logd0;                    // the same for the dust temperature
  double logd9;
  double dlogd;
  double dust_t_end;               // DustTemperatureEnd
  double eq_step;                  // 0.1 * dlogt, the limiter's step
  double tiny8;
  double huge8;
  double fh;                       // HydrogenFractionByMass
  double acc;                      // subcycle_accuracy
  double two_kboltz;               // 2 k_B
  double mass_h;
  const void* table[N_TABLE];      // T tables; k13dd (bins, 14), h2dust
  const void* scalar[N_SCALAR];    // one T each
  const void* in[N_IN];            // itmask is bool
  void* out;                       // (rows, n) T
};

namespace {

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
__device__ __forceinline__ double t_exp(double x) { return exp(x); }
__device__ __forceinline__ float t_exp(float x) { return expf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_pow(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float t_pow(float x, float y) {
  return powf(x, y);
}
__device__ __forceinline__ double t_abs(double x) { return fabs(x); }
__device__ __forceinline__ float t_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double t_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float t_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double t_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float t_min(float a, float b) {
  return fminf(a, b);
}

// torch.clamp(a, min=lo) and torch.maximum(a, lo): NaN in either is kept.
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return a != a ? a : (b != b ? b : t_max(a, b));
}
// torch.clamp(a, max=hi) and torch.minimum(a, hi), likewise.
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return a != a ? a : (b != b ? b : t_min(a, b));
}

template <typename T>
__device__ __forceinline__ T ldg(const void* p, long long i) {
  return __ldg(static_cast<const T*>(p) + i);
}

// lookup.py TableIndex: the 0-based bin, the fraction within it, and the
// f64 bin edges.
template <typename T>
struct Index {
  long long idx;
  T tdef;
  double t1, t2;
};

// lookup.py table_index at log T ``logtem`` on a table of ``n_bins`` bins
// from log T ``l0`` to ``l9``, ``dl`` apart (solve_rate_cool_g.F:
// 1202-1221).
template <typename T>
__device__ Index<T> table_index(T logtem, int n_bins, double l0, double l9,
                                double dl) {
  Index<T> r;
  const T lo = T(l0);
  logtem = tmin(tmax(logtem, lo), T(l9));
  long long i = static_cast<long long>(
      mul(sub(logtem, lo), div(T(1), T(dl))));
  i = i > 0 ? i : 0;
  r.idx = i < n_bins - 2 ? i : n_bins - 2;
  const double i64 = static_cast<double>(r.idx);
  r.t1 = __dadd_rn(l0, __dmul_rn(i64, dl));
  r.t2 = __dadd_rn(l0, __dmul_rn(__dadd_rn(i64, 1.0), dl));
  r.tdef = div(sub(logtem, T(r.t1)), T(__dsub_rn(r.t2, r.t1)));
  return r;
}

// lookup.py lookup: lo + (hi - lo) * tdef
template <typename T>
__device__ __forceinline__ T lerp(T lo, T hi, T tdef) {
  return add(lo, mul(sub(hi, lo), tdef));
}

template <typename T>
__device__ __forceinline__ T lookup(const void* table, const Index<T>& ti) {
  return lerp(ldg<T>(table, ti.idx), ldg<T>(table, ti.idx + 1), ti.tdef);
}

// chemistry_step.py _wg2019_shield (solve_rate_cool_g.F:1451-1475)
template <typename T>
__device__ T wg2019_shield(T n_h2, T tgas, T ngas, const RatesArgs& a) {
  const T tt = tmin(tmax(tgas, T(1.0e2)), T(8.0e3));
  const T nt = tmin(ngas, T(1.0e7));
  const T lt = t_log10(tt);
  const T awg = add(mul(sub(mul(T(0.8711), lt), T(1.928)),
                        t_exp(mul(T(-0.2856), t_log10(nt)))),
                    add(mul(T(-0.9639), lt), T(3.892)));
  const T x = mul(T(2.0e-15), n_h2);
  const T b_doppler = mul(
      T(1.0e-5),
      t_sqrt(mul(mul(tgas, T(a.two_kboltz)), div(T(1), T(a.mass_h)))));
  const T s = t_sqrt(add(x, T(1)));
  const T f = add(mul(div(T(1), t_pow(add(div(x, b_doppler), T(1)), awg)),
                      T(0.965)),
                  div(mul(T(0.035), t_exp(mul(T(-8.5e-4), s))), s));
  return tmin(f, T(1));
}

// chemistry_step.py _rahmati_fshield (solve_rate_cool_g.F:1496-1534)
template <typename T>
__device__ T rahmati_fshield(T avgsig, T k_rate, T tgas, T nloc,
                             T tbase1) {
  const T nssh = mul(
      mul(mul(t_pow(mul(avgsig, div(T(1), T(2.49e-18))), T(-2.0 / 3.0)),
              T(6.73e-3)),
          t_pow(mul(tgas, div(T(1), T(1.0e4))), T(0.17))),
      t_pow(mul(div(k_rate, tbase1), div(T(1), T(1.0e-12))),
            T(2.0 / 3.0)));
  const T nratio = div(nloc, nssh);
  return add(mul(T(0.98), t_pow(add(t_pow(nratio, T(1.64)), T(1)),
                                T(-2.28))),
             mul(T(0.02), t_pow(add(nratio, T(1)), T(-0.84))));
}

// chemistry_step.py lookup_cool_rates' shielded(): a zero rate stays 0
template <typename T>
__device__ __forceinline__ T shielded(T rate, T factor, T tiny8) {
  return rate < tiny8 ? T(0) : mul(rate, factor);
}

// solver.py _h2_limit_value's heq: the k13/k22 equilibrium H abundance
template <typename T>
__device__ __forceinline__ T h2_equilibrium(T k13, T k22, T fh, T d) {
  return mul(mul(div(T(1), mul(T(4), k22)), T(-1)),
             sub(k13, t_sqrt(add(mul(mul(mul(mul(T(8), k13), k22), fh), d),
                                 mul(k13, k13)))));
}

// The density-dependent k13 (solve_rate_cool_g.F:1707-1734) from the 14
// k13dd coefficients lerped at the cell's bin.
template <typename T>
__device__ T k13_density(const RatesArgs& a, const Index<T>& ti, T tgas,
                         T hi_dom) {
  const T* dd = static_cast<const T*>(a.table[T_k13dd]);
  T c[14];
#pragma unroll
  for (int q = 0; q < 14; ++q) {
    c[q] = lerp(__ldg(dd + ti.idx * 14 + q), __ldg(dd + (ti.idx + 1) * 14 + q),
                ti.tdef);
  }
  const T tiny8 = T(a.tiny8);
  const T nh = tmin(hi_dom, T(1.0e9));
  auto term = [&](int p, int q, int r, int s, int e) {
    T v = sub(add(sub(c[p], div(c[q], add(t_pow(div(nh, c[r]), c[e]),
                                          T(1)))),
                  c[p + 2]),
              div(c[q + 2], add(t_pow(div(nh, c[s]), c[e]), T(1))));
    return tmax(t_pow(T(10), v), tiny8);
  };
  const T cid = term(0, 1, 4, 5, 6);
  const T dt = term(7, 8, 11, 12, 13);
  return tgas >= T(500) && tgas < T(1.0e6) ? add(dt, cid) : tiny8;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
rates_kernel(const __grid_constant__ RatesArgs a) {
  const long long i = blockIdx.x * (long long)BLOCK + threadIdx.x;
  if (i >= a.n) return;
  auto in = [&](int slot) { return ldg<T>(a.in[slot], i); };
  auto scalar = [&](int slot) {
    return *static_cast<const T*>(a.scalar[slot]);
  };
  T* out = static_cast<T*>(a.out);
  auto put = [&](int row, T v) { out[row * a.n + i] = v; };
  const int ispecies = a.ispecies;
  const T tiny8 = T(a.tiny8);
  const T tgas = in(I_tgas);
  const T d = in(I_density);
  const T dom = scalar(S_dom);

  // every rate of the network at log T (solve_rate_cool_g.F:1206-1323)
  const T logt = t_log(tgas);
  const Index<T> ti = table_index(logt, a.n_bins, a.logt0, a.logt9,
                                  a.dlogt);
  const int nk = ispecies == 1 ? 8 : (ispecies == 2 ? 25 : 32);
  for (int j = 0; j < nk; ++j) {
    if (j != T_k13) put(j, lookup<T>(a.table[j], ti));
  }
  T k13 = T(0), k22 = T(0);
  if (ispecies > 1) {
    k13 = lookup<T>(a.table[T_k13], ti);
    k22 = lookup<T>(a.table[T_k22], ti);
    if (a.three_body_rate == 0) {
      k13 = k13_density(a, ti, tgas, mul(in(I_HI), dom));
    }
    put(T_k13, k13);
  }
  int row = nk + 7;

  // h2dust: bilinear in (T, T_dust), times dust2gas; the dust melts above
  // the table's end (solve_rate_cool_g.F:1327-1378)
  if (a.anydust) {
    const T tdust = in(I_tdust);
    const Index<T> di = table_index(t_log(tdust), a.n_dust_bins, a.logd0,
                                    a.logd9, a.dlogd);
    const T* h = static_cast<const T*>(a.table[T_h2dust]);
    const long long nd = a.n_dust_bins;
    const long long r0 = ti.idx * nd + di.idx, r1 = r0 + nd;
    const T dusti1 = lerp(__ldg(h + r0), __ldg(h + r1), ti.tdef);
    const T dusti2 = lerp(__ldg(h + r0 + 1), __ldg(h + r1 + 1), ti.tdef);
    const T h2dust = mul(lerp(dusti1, dusti2, di.tdef), in(I_dust2gas));
    put(row++, tdust > T(a.dust_t_end) ? tiny8 : h2dust);
  }

  // the radiation shields (solve_rate_cool_g.F:1382-1676)
  T k24 = scalar(S_k24), k25 = scalar(S_k25), k26 = scalar(S_k26);
  T k28 = scalar(S_k28), k29 = scalar(S_k29), k30 = scalar(S_k30);
  T k31 = scalar(S_k31);
  if (ispecies > 1) {
    if (a.rt) k31 = add(k31, in(I_RT_H2_dissociation_rate));
    if (a.h2_self_shielding > 0) {
      const T mmw = in(I_mmw);
      T l_h2 = T(0);
      if (a.h2_self_shielding == 1) {
        l_h2 = in(I_l_h2shield_field);
      } else if (a.h2_self_shielding == 2) {
        l_h2 = mul(in(I_H2_self_shielding_length), scalar(S_xbase1));
      } else if (a.h2_self_shielding == 3) {
        l_h2 = mul(scalar(S_c_ljeans), t_sqrt(div(tgas, mul(d, mmw))));
      }
      const T n_h2 = mul(mul(dom, in(I_H2I)), l_h2);
      const T ngas = div(mul(d, dom), mmw);
      k31 = mul(wg2019_shield(n_h2, tgas, ngas, a), k31);
    }
    if (a.h2_custom_shielding > 0) {
      k31 = mul(in(I_H2_custom_shielding_factor), k31);
    }
  }
  const int method = a.self_shielding_method;
  if (method > 0) {
    T nh = add(in(I_HI), in(I_HII));
    if (ispecies > 1) {
      nh = add(add(add(nh, in(I_HM)), in(I_H2I)), in(I_H2II));
      if (ispecies > 2) {
        nh = add(add(nh, mul(T(0.5), add(in(I_DI), in(I_DII)))),
                 mul(mul(T(2), in(I_HDI)), div(T(1), T(3))));
      }
    }
    const T tbase1 = scalar(S_tbase1);
    const T f_h = rahmati_fshield(scalar(S_crsHI), scalar(S_k24), tgas,
                                  mul(nh, dom), tbase1);
    const T nhe = mul(T(0.25), add(add(in(I_HeI), in(I_HeII)), in(I_HeIII)));
    const T f_he = rahmati_fshield(scalar(S_crsHeI), scalar(S_k26), tgas,
                                   mul(nhe, dom), tbase1);
    k24 = shielded(k24, f_h, tiny8);
    k29 = shielded(k29, f_h, tiny8);
    if (method >= 2) {
      k26 = shielded(k26, f_he, tiny8);
      k28 = shielded(k28, f_he, tiny8);
      k30 = shielded(k30, f_he, tiny8);
    }
    if (method == 3) k25 = T(0);
  }
  put(nk, k24);
  put(nk + 1, k25);
  put(nk + 2, k26);
  put(nk + 3, k28);
  put(nk + 4, k29);
  put(nk + 5, k30);
  put(nk + 6, k31);

  // the H2-equilibrium dt limit (solve_rate_cool_g.F:592-643), +huge8
  // where it does not fire
  if (ispecies > 1) {
    const T edot = in(I_edot);
    const bool apply = mul(d, dom) > T(1.0e8) && edot > T(0) &&
        __ldg(static_cast<const unsigned char*>(a.in[I_itmask]) + i) != 0;
    const T fh = T(a.fh);
    const T t1 = T(ti.t1), t2 = T(ti.t2);
    const T width = T(__dsub_rn(ti.t2, ti.t1));
    const T lo13 = ldg<T>(a.table[T_k13], ti.idx);
    const T hi13 = ldg<T>(a.table[T_k13], ti.idx + 1);
    const T lo22 = ldg<T>(a.table[T_k22], ti.idx);
    const T hi22 = ldg<T>(a.table[T_k22], ti.idx + 1);
    auto heq_at = [&](T eqt) {
      const T eqtdef = div(sub(eqt, t1), width);
      return h2_equilibrium(lerp(lo13, hi13, eqtdef),
                            lerp(lo22, hi22, eqtdef), fh, d);
    };
    const T step = T(a.eq_step);
    const T eqt2 = tmin(add(logt, step), t2);
    const T eqt1 = tmax(sub(logt, step), t1);
    const T heq2 = heq_at(eqt2);
    const T heq1 = heq_at(eqt1);
    const T dheq = mul(mul(div(t_abs(sub(heq2, heq1)),
                               sub(t_exp(eqt2), t_exp(eqt1))),
                           div(tgas, in(I_p2d))),
                       edot);
    const T heq = h2_equilibrium(k13, k22, fh, d);
    const T limit = div(mul(heq, T(a.acc)), dheq);
    put(row, apply ? limit : T(a.huge8));
  }
}

}  // namespace

extern "C" {

// Slot counts and the argument struct's size, so the Python wrapper can
// check its layout against this build's.
int grackle_rates_layout(int* n_in, int* n_scalar, int* n_table,
                         int* block) {
  *n_in = N_IN;
  *n_scalar = N_SCALAR;
  *n_table = N_TABLE;
  *block = BLOCK;
  return (int)sizeof(RatesArgs);
}

// The rates, shields, h2dust and H2-equilibrium limit of every cell on
// `stream`, float (is_double = 0) or double operands.  Returns
// cudaGetLastError() after the launch.
int grackle_rates_lookup(const RatesArgs* args, int is_double,
                         void* stream) {
  if (args->n <= 0) return 0;
  const unsigned grid = (unsigned)((args->n + BLOCK - 1) / BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    rates_kernel<double><<<grid, BLOCK, 0, s>>>(*args);
  } else {
    rates_kernel<float><<<grid, BLOCK, 0, s>>>(*args);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
