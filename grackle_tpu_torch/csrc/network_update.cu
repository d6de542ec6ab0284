// One subcycle's network region for every cell, as one CUDA launch.
//
// Replaces grackle_tpu/ops/network_kernel.py network_update_pallas (the
// JAX package's one Pallas kernel, a pl.pallas_call over (TR, 128) VMEM
// blocks of grackle_tpu/ops/network.py network_update).  It computes
// grackle_tpu_torch/ops/network.py network_update -- rate sums
// (chemistry_step.rate_timestep), dt limiter, energy update,
// backward-Euler Gauss-Seidel species sweep (chemistry_step.step_rate)
// and the clock/retirement bookkeeping (solve_rate_cool_g.F:554-813) --
// operation for operation, in the same order.  That Python function is
// this kernel's plain twin; change the two together.
//
// What bounds it on an H100: memory, and the latency of the body.  The
// region has no transcendentals and no reductions, while the flagship
// 12-species configuration reads 70 per-cell operands and writes 22:
// 700 B a cell in f64, 57 MB for the compacted path's 81,920-cell batch
// and 734 MB at 1,048,576 cells.  The f64 build has about 970
// double-precision instructions (a static count of its sm_90a code, with
// some 30 IEEE divisions expanded among them; chip_smoke.py
// OPS_PER_CELL), a quarter of the bytes' time at the card's f64 rate but
// in long dependent chains: a warp takes microseconds per cell and an SM
// needs many warps in flight to keep memory busy.  Every option of the
// Pallas kernel is taken: primordial_chemistry 0-3 (0, tabulated mode,
// updates only the energy and the clock), the Neumaier pairs of
// compensated_sums = 1 (energy_lo / ttot_lo in and out) and the
// radiative-transfer ionization-rate fields.
//
// Design, for Hopper:
// - A persistent grid: min(tiles, CTAs per SM x SMs) CTAs, each walking
//   the tiles blockIdx.x, blockIdx.x + gridDim.x, ... of TILE = 128
//   cells, one cell a thread, at the occupancy of MIN_CTAS_PER_SM.  The
//   SM count and the occupancy are queried once per device, not per
//   launch.
// - The threads load their operands through the read-only path (__ldg)
//   and store their results through __restrict__ pointers, so no load
//   waits for an earlier store.  Staging a tile's operands in shared
//   memory with TMA bulk copies measured slower at every width on the
//   H100 (PERF.md): the twelve warps that the body's latency needs fill
//   the SM's shared memory with one f64 stage each, so a stage cannot be
//   refilled while its tile computes.
// - All operand pointers ride in one struct passed by value as a
//   __grid_constant__ parameter (under the 4 KB limit).  Outputs are
//   plain coalesced stores: neighbouring threads, neighbouring cells.
//   The configuration flags are runtime ints, uniform over the grid, so
//   the branches never diverge within a warp.  Masks are bytes
//   (torch.bool).
//
// Numerics: built with -fmad=false and IEEE division, so no product is
// contracted into an FMA: each operation rounds as the twin's separate
// PyTorch op does (the twin divides by host scalars with IEEE division,
// ops/common.py div_host), and the results equal the twin's bit for bit
// in f32 and f64.  The compensated two-sum needs exactly that: IEEE adds
// that the compiler neither contracts nor reassociates.
// Scalars the twin combines in host double precision (Gamma-1,
// 1.01*TemperatureStart) arrive precomputed as doubles and are rounded
// once to T, as PyTorch rounds a Python float.  The timestep is a double
// in device memory (the solvers' 0-d float64 tensor, so that a CUDA graph
// replays with a new dt); 0.5*dt and tolerance*dt are double products
// here, as the twin forms them, and rounded once to T.  The call's unit
// scalars dom and chunit and the unshielded photo rate k27 are T values
// in device memory too, elements of the call's scalar block
// (ops/common.py scalar_block), which the twin reads as 0-d tensors: a
// graph replays with a new a_value.  Each thread loads them once, as the
// Pallas kernel reads its scalars from one SMEM operand.
//
// Build (ops/network_kernel.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -ftz=false
//        -shared -Xcompiler -fPIC -o libnetwork_update.so network_update.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Operand slots; grackle_tpu_torch/ops/network_kernel.py lists the same
// names in the same order (FIELD_SLOTS .. CARRY_SLOTS, OUT_*_SLOTS).
enum In {
  // fields
  I_density, I_energy, I_de, I_HI, I_HII, I_HeI, I_HeII, I_HeIII,
  I_HM, I_H2I, I_H2II, I_DI, I_DII, I_HDI,
  I_RT_HI_ionization_rate, I_RT_HeI_ionization_rate,
  I_RT_HeII_ionization_rate,
  // interpolated rates
  I_k1, I_k2, I_k3, I_k4, I_k5, I_k6, I_k57, I_k58,
  I_k7, I_k8, I_k9, I_k10, I_k11, I_k12, I_k13, I_k14, I_k15,
  I_k16, I_k17, I_k18, I_k19, I_k22, I_n_cr_n, I_n_cr_d1, I_n_cr_d2,
  I_k50, I_k51, I_k52, I_k53, I_k54, I_k55, I_k56,
  // shielded photo rates (k27 is a scalar)
  I_s24, I_s25, I_s26, I_s28, I_s29, I_s30, I_s31,
  I_h2dust,
  // cool1d_multi results
  I_edot, I_tgas, I_p2d, I_rhoH, I_cool_tgasold, I_cool_tdust,
  // carry
  I_ttot, I_tgasold, I_tdust, I_dedot_prev, I_HIdot_prev, I_dtit_prev,
  I_itmask, I_cell_it, I_capped, I_energy_lo, I_ttot_lo,
  I_h2_limit,
  N_IN
};

// Device scalars: pointers into the call's scalar block, one T each
// (ops/network_kernel.py SCALAR_SLOTS).
enum Scalar { S_dom, S_chunit, S_k27, N_SCALAR };

enum Out {
  O_energy, O_de, O_HI, O_HII, O_HeI, O_HeII, O_HeIII,
  O_HM, O_H2I, O_H2II, O_DI, O_DII, O_HDI,
  O_ttot, O_tgasold, O_tdust, O_dedot_prev, O_HIdot_prev, O_dtit_prev,
  O_itmask, O_cell_it, O_capped, O_energy_lo, O_ttot_lo,
  N_OUT
};

}  // namespace

// Cells per tile: a CTA is four warps, one cell a thread
// (ops/network_kernel.py TILE).  The launch bounds keep MIN_CTAS_PER_SM
// CTAs resident on an SM: three in f64 (at most 168 registers a thread)
// and five in f32 (at most 102), so twelve or twenty warps an SM hide the
// body's long dependency chains.  Left to itself the compiler gives the
// f32 body 108 registers, four CTAs an SM, and that build measured 12%
// slower at 81,920 cells (PERF.md).
constexpr int TILE = 128;
template <typename T>
constexpr int MIN_CTAS_PER_SM = sizeof(T) == 8 ? 3 : 5;

// Launch arguments; mirrored field for field by ops/network_kernel.py
// _NetworkArgs (a ctypes.Structure).
struct NetworkArgs {
  long long n;
  int ispecies;               // primordial_chemistry, 0..3
  int anydust;                // h2_on_dust > 0 or dust_chemistry > 0
  int with_radiative_cooling;
  int deuterium_coupled;      // deuterium_coupled_solve
  int max_iterations;
  int compensated;            // compensated_sums
  int rt;                     // use_radiative_transfer
  int rt_hydrogen_only;       // radiative_transfer_hydrogen_only
  int grid;                   // CTAs of the launch: the persistent grid
  const void* dt;             // full-step timestep: a double in device memory
  double tolerance;           // dtype_tolerance (retire at tolerance*dt)
  double tiny8;               // dtype floor (ops/common.py)
  double huge8;               // dtype ceiling (ops/common.py)
  double acc;                 // subcycle_accuracy
  double gamma_m1;            // Gamma - 1
  double t_start_101;         // 1.01 * TemperatureStart
  const void* scalar[N_SCALAR];  // dom, chunit, k27 (null below chem 1)
  const void* in[N_IN];
  void* out[N_OUT];
};

namespace {

// NaN-propagating min/max, as torch.minimum/maximum/clamp.
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T tabs(T a) {
  return a < T(0) ? -a : (a == T(0) ? T(0) : a);
}

template <typename V>
__device__ __forceinline__ V ld(const NetworkArgs& a, long long i, int slot) {
  return __ldg(static_cast<const V*>(a.in[slot]) + i);
}

template <typename V>
__device__ __forceinline__ void st(const NetworkArgs& a, long long i,
                                   int slot, V v) {
  V* __restrict__ out = static_cast<V*>(a.out[slot]);
  out[i] = v;
}

// (hi + lo) + x as a renormalized pair (Neumaier two-sum); the twin's
// ops/network.py _two_sum, add for add.
template <typename T>
__device__ __forceinline__ void two_sum(T hi, T lo, T x, T& hi_out,
                                        T& lo_out) {
  const T s = hi + x;
  const T err = tabs(hi) >= tabs(x) ? (hi - s) + x : (x - s) + hi;
  lo = lo + err;
  hi_out = s + lo;
  lo_out = lo - (hi_out - s);
}

// The device scalars as one thread holds them.
template <typename T>
struct Scalars {
  T dom, chunit, k27;
};

template <typename T>
__device__ __forceinline__ void network_cell(const NetworkArgs& a,
                                             long long i, double dt64,
                                             const Scalars<T>& sc) {
  const int isp = a.ispecies;
  const bool dust = a.anydust != 0;
  const bool comp = a.compensated != 0;
  // radiative-transfer rate fields enter only the species network
  const bool irt = a.rt != 0 && isp > 0;
  const bool rt_all = irt && a.rt_hydrogen_only == 0;
  const T tiny = T(1.0e-20);
  const T tiny8 = T(a.tiny8);
  const T dt = T(dt64);
  const T dom = sc.dom;

  const bool itmask = ld<uint8_t>(a, i, I_itmask) != 0;
  const int it = ld<int>(a, i, I_cell_it);
  const bool capped = ld<uint8_t>(a, i, I_capped) != 0;
  const T ttot = ld<T>(a, i, I_ttot);
  const T energy_lo = comp ? ld<T>(a, i, I_energy_lo) : T(0);
  const T ttot_lo = comp ? ld<T>(a, i, I_ttot_lo) : T(0);

  const T density = ld<T>(a, i, I_density);
  const T energy_in = ld<T>(a, i, I_energy);
  T de = 0, HI = 0, HII = 0, HeI = 0, HeII = 0, HeIII = 0;
  T HM = 0, H2I = 0, H2II = 0, DI = 0, DII = 0, HDI = 0;
  if (isp > 0) {
    de = ld<T>(a, i, I_de);
    HI = ld<T>(a, i, I_HI);
    HII = ld<T>(a, i, I_HII);
    HeI = ld<T>(a, i, I_HeI);
    HeII = ld<T>(a, i, I_HeII);
    HeIII = ld<T>(a, i, I_HeIII);
  }
  if (isp > 1) {
    HM = ld<T>(a, i, I_HM);
    H2I = ld<T>(a, i, I_H2I);
    H2II = ld<T>(a, i, I_H2II);
  }
  if (isp > 2) {
    DI = ld<T>(a, i, I_DI);
    DII = ld<T>(a, i, I_DII);
    HDI = ld<T>(a, i, I_HDI);
  }
  const T kphHI = irt ? ld<T>(a, i, I_RT_HI_ionization_rate) : T(0);
  const T kphHeI = rt_all ? ld<T>(a, i, I_RT_HeI_ionization_rate) : T(0);
  const T kphHeII = rt_all ? ld<T>(a, i, I_RT_HeII_ionization_rate) : T(0);

  T k1 = 0, k2 = 0, k3 = 0, k4 = 0, k5 = 0, k6 = 0, k57 = 0, k58 = 0;
  if (isp > 0) {
    k1 = ld<T>(a, i, I_k1); k2 = ld<T>(a, i, I_k2);
    k3 = ld<T>(a, i, I_k3); k4 = ld<T>(a, i, I_k4);
    k5 = ld<T>(a, i, I_k5); k6 = ld<T>(a, i, I_k6);
    k57 = ld<T>(a, i, I_k57); k58 = ld<T>(a, i, I_k58);
  }
  T k7 = 0, k8 = 0, k9 = 0, k10 = 0, k11 = 0, k12 = 0, k13 = 0, k14 = 0,
    k15 = 0, k16 = 0, k17 = 0, k18 = 0, k19 = 0, k22 = 0, n_cr_n = 0,
    n_cr_d1 = 0, n_cr_d2 = 0;
  if (isp > 1) {
    k7 = ld<T>(a, i, I_k7); k8 = ld<T>(a, i, I_k8);
    k9 = ld<T>(a, i, I_k9); k10 = ld<T>(a, i, I_k10);
    k11 = ld<T>(a, i, I_k11); k12 = ld<T>(a, i, I_k12);
    k13 = ld<T>(a, i, I_k13); k14 = ld<T>(a, i, I_k14);
    k15 = ld<T>(a, i, I_k15); k16 = ld<T>(a, i, I_k16);
    k17 = ld<T>(a, i, I_k17); k18 = ld<T>(a, i, I_k18);
    k19 = ld<T>(a, i, I_k19); k22 = ld<T>(a, i, I_k22);
    n_cr_n = ld<T>(a, i, I_n_cr_n);
    n_cr_d1 = ld<T>(a, i, I_n_cr_d1);
    n_cr_d2 = ld<T>(a, i, I_n_cr_d2);
  }
  T s24 = 0, s25 = 0, s26 = 0;
  if (isp > 0) {
    s24 = ld<T>(a, i, I_s24); s25 = ld<T>(a, i, I_s25);
    s26 = ld<T>(a, i, I_s26);
  }
  T s28 = 0, s29 = 0, s30 = 0, s31 = 0;
  const T s27 = sc.k27;
  if (isp > 1) {
    s28 = ld<T>(a, i, I_s28); s29 = ld<T>(a, i, I_s29);
    s30 = ld<T>(a, i, I_s30); s31 = ld<T>(a, i, I_s31);
  }
  const T h2dust = dust && isp > 1 ? ld<T>(a, i, I_h2dust) : T(0);

  T edot = ld<T>(a, i, I_edot);
  const T tgas = ld<T>(a, i, I_tgas);
  const T p2d = ld<T>(a, i, I_p2d);
  const T rhoH = ld<T>(a, i, I_rhoH);

  // compensated: the true clock is ttot + ttot_lo
  const T t_resid = comp ? (dt - ttot) - ttot_lo : dt - ttot;
  const T acc = T(a.acc);
  T dtit = T(a.huge8);

  if (isp > 0) {
    // ---- rate_timestep (solve_rate_cool_g.F:1743-1953) ----
    T dedot, HIdot;
    if (isp == 1) {
      dedot = k1 * HI * de
          + k3 * HeI * de / T(4.0)
          + k5 * HeII * de / T(4.0)
          - k2 * HII * de
          - k4 * HeII * de / T(4.0)
          - k6 * HeIII * de / T(4.0)
          + k57 * HI * HI
          + k58 * HI * HeI / T(4.0)
          + (s24 * HI + s25 * HeII / T(4.0) + s26 * HeI / T(4.0));
      HIdot = -k1 * HI * de
          + k2 * HII * de
          - k57 * HI * HI
          - k58 * HI * HeI / T(4.0)
          - s24 * HI;
    } else {
      HIdot = -k1 * de * HI
          - k7 * de * HI
          - k8 * HM * HI
          - k9 * HII * HI
          - k10 * H2II * HI / T(2.0)
          - T(2.0) * k22 * (HI * HI) * HI
          + k2 * HII * de
          + T(2.0) * k13 * HI * H2I / T(2.0)
          + k11 * HII * H2I / T(2.0)
          + T(2.0) * k12 * de * H2I / T(2.0)
          + k14 * HM * de
          + k15 * HM * HI
          + T(2.0) * k16 * HM * HII
          + T(2.0) * k18 * H2II * de / T(2.0)
          + k19 * H2II * HM / T(2.0)
          - k57 * HI * HI
          - k58 * HI * HeI / T(4.0)
          - s24 * HI
          + T(2.0) * s31 * H2I / T(2.0);
      if (dust) HIdot = HIdot - T(2.0) * h2dust * rhoH;
      dedot = k1 * HI * de
          + k3 * HeI * de / T(4.0)
          + k5 * HeII * de / T(4.0)
          + k8 * HM * HI
          + k15 * HM * HI
          + k17 * HM * HII
          + k14 * HM * de
          - k2 * HII * de
          - k4 * HeII * de / T(4.0)
          - k6 * HeIII * de / T(4.0)
          - k7 * HI * de
          - k18 * H2II * de / T(2.0)
          + k57 * HI * HI
          + k58 * HI * HeI / T(4.0)
          + (s24 * HI + s25 * HeII / T(4.0) + s26 * HeI / T(4.0));

      // H2 formation heating, Omukai 2000 Eq. 23 (F:1888-1919)
      const T h2heatfac = T(1.0) / (
          T(1.0) + n_cr_n / (dom * (HI * n_cr_d1 + H2I * T(0.5) * n_cr_d2)));
      T H2delta = HI * (T(4.48) * k22 * (HI * HI)
                        - T(4.48) * k13 * H2I / T(2.0));
      H2delta = H2delta > T(0.0) ? H2delta * h2heatfac : H2delta;
      if (dust) {
        H2delta = H2delta
            + (h2dust * HI * rhoH * (T(0.2) + T(4.2) * h2heatfac));
      }
      edot = edot + sc.chunit * H2delta;
    }
    if (irt) {
      HIdot = HIdot - kphHI * HI;
      if (rt_all) {
        dedot = dedot
            + (kphHI * HI + kphHeI * HeI / T(4.0) + kphHeII * HeII / T(4.0));
      } else {
        dedot = dedot + kphHI * HI;
      }
    }

    // ---- dt limiter (solve_rate_cool_g.F:554-692) ----
    dedot = tabs(dedot) < tiny8 ? tmin(de, tiny) : dedot;
    HIdot = tabs(HIdot) < tiny8 ? tmin(HI, tiny) : HIdot;
    const bool balanced =
        (tmin(tabs(k1 * de * HI), tabs(k2 * HII * de))
         / tmax(tabs(dedot), tabs(HIdot))) > T(1.0e6);
    if (balanced) {
      dedot = tiny8;
      HIdot = tiny8;
    }
    if (it > 50) {
      dedot = tmin(tabs(dedot), tabs(ld<T>(a, i, I_dedot_prev)));
      HIdot = tmin(tabs(HIdot), tabs(ld<T>(a, i, I_HIdot_prev)));
    }
    dtit = tmin(tmin(tabs(acc * de / dedot), tabs(acc * HI / HIdot)),
                tmin(t_resid, T(0.5 * dt64)));
    if (isp > 1) dtit = tmin(dtit, ld<T>(a, i, I_h2_limit));
  }

  // ---- energy timestep (solve_rate_cool_g.F:698-750) ----
  const T energy = tmax(p2d / T(a.gamma_m1), tiny8);
  if (tgas <= T(a.t_start_101) && edot < T(0.0)) edot = tiny8;
  if (tabs(edot) < tiny8) edot = tiny8;
  dtit = tmin(tabs(acc * energy / edot), tmin(t_resid, dtit));

  // ---- energy update (solve_rate_cool_g.F:754-773) ----
  T e_new = energy_in;
  T e_lo_new = energy_lo;
  if (a.with_radiative_cooling == 1) {
    if (comp) {
      const T incr = itmask ? edot / density * dtit : T(0.0);
      two_sum(energy_in, energy_lo, incr, e_new, e_lo_new);
    } else if (itmask) {
      e_new = energy_in + edot / density * dtit;
    }
  }
  st<T>(a, i, O_energy, e_new);
  if (comp) st<T>(a, i, O_energy_lo, e_lo_new);

  if (isp > 0) {
    // ---- step_rate: BE Gauss-Seidel sweep (F:1961-2413) ----
    T scoef, acoef;
    T HIp, HIIp, dep, HeIp, HeIIp, HeIIIp;
    T HMp = 0, H2Ip = 0, H2IIp = 0, DIp = 0, DIIp = 0, HDIp = 0;
    if (isp == 1) {
      scoef = k2 * HII * de;
      acoef = k1 * de + k57 * HI + k58 * HeI / T(4.0) + s24;
      if (irt) acoef = acoef + kphHI;
      HIp = (scoef * dtit + HI) / (T(1.0) + acoef * dtit);

      scoef = k1 * HIp * de + k57 * HIp * HIp + k58 * HIp * HeI / T(4.0)
          + s24 * HIp;
      if (irt) scoef = scoef + kphHI * HIp;
      acoef = k2 * de;
      HIIp = (scoef * dtit + HII) / (T(1.0) + acoef * dtit);

      scoef = k57 * HIp * HIp + k58 * HIp * HeI / T(4.0)
          + s24 * HI + s25 * HeII / T(4.0) + s26 * HeI / T(4.0);
      if (rt_all) {
        scoef = scoef
            + (kphHI * HI + kphHeI * HeI / T(4.0) + kphHeII * HeII / T(4.0));
      } else if (irt) {
        scoef = scoef + kphHI * HI;
      }
      acoef = -(k1 * HI - k2 * HII
                + k3 * HeI / T(4.0) - k6 * HeIII / T(4.0)
                + k5 * HeII / T(4.0) - k4 * HeII / T(4.0));
      dep = (scoef * dtit + de) / (T(1.0) + acoef * dtit);
    }

    // helium, all ispecies (F:2115-2159)
    scoef = k4 * HeII * de;
    acoef = k3 * de + s26;
    if (rt_all) acoef = acoef + kphHeI;
    HeIp = (scoef * dtit + HeI) / (T(1.0) + acoef * dtit);

    scoef = k3 * HeIp * de + k6 * HeIII * de + s26 * HeIp;
    if (rt_all) scoef = scoef + kphHeI * HeIp;
    acoef = k4 * de + k5 * de + s25;
    if (rt_all) acoef = acoef + kphHeII;
    HeIIp = (scoef * dtit + HeII) / (T(1.0) + acoef * dtit);

    scoef = k5 * HeIIp * de + s25 * HeIIp;
    if (rt_all) scoef = scoef + kphHeII * HeIIp;
    acoef = k6 * de;
    HeIIIp = (scoef * dtit + HeIII) / (T(1.0) + acoef * dtit);

    if (isp > 1) {
      // 9-species molecular network (F:2163-2306)
      scoef = k2 * HII * de
          + T(2.0) * k13 * HI * H2I / T(2.0)
          + k11 * HII * H2I / T(2.0)
          + T(2.0) * k12 * de * H2I / T(2.0)
          + k14 * HM * de
          + k15 * HM * HI
          + T(2.0) * k16 * HM * HII
          + T(2.0) * k18 * H2II * de / T(2.0)
          + k19 * H2II * HM / T(2.0)
          + T(2.0) * s31 * H2I / T(2.0);
      acoef = k1 * de + k7 * de + k8 * HM
          + k9 * HII + k10 * H2II / T(2.0)
          + T(2.0) * k22 * (HI * HI)
          + k57 * HI + k58 * HeI / T(4.0)
          + s24;
      if (irt) acoef = acoef + kphHI;
      if (dust) acoef = acoef + T(2.0) * h2dust * rhoH;
      HIp = (scoef * dtit + HI) / (T(1.0) + acoef * dtit);

      scoef = k1 * HI * de
          + k10 * H2II * HI / T(2.0)
          + k57 * HI * HI
          + k58 * HI * HeI / T(4.0)
          + s24 * HI;
      if (irt) scoef = scoef + kphHI * HI;
      acoef = k2 * de + k9 * HI + k11 * H2I / T(2.0) + k16 * HM + k17 * HM;
      HIIp = (scoef * dtit + HII) / (T(1.0) + acoef * dtit);

      scoef = k8 * HM * HI + k15 * HM * HI
          + k17 * HM * HII
          + k57 * HI * HI + k58 * HI * HeI / T(4.0)
          + s24 * HIp + s25 * HeIIp / T(4.0)
          + s26 * HeIp / T(4.0);
      if (rt_all) {
        scoef = scoef + (kphHI * HIp + kphHeI * HeIp / T(4.0)
                         + kphHeII * HeIIp / T(4.0));
      } else if (irt) {
        scoef = scoef + kphHI * HIp;
      }
      acoef = -(k1 * HI - k2 * HII
                + k3 * HeI / T(4.0) - k6 * HeIII / T(4.0)
                + k5 * HeII / T(4.0) - k4 * HeII / T(4.0)
                + k14 * HM
                - k7 * HI
                - k18 * H2II / T(2.0));
      dep = (scoef * dtit + de) / (T(1.0) + acoef * dtit);

      // H2
      scoef = T(2.0) * (k8 * HM * HI
                        + k10 * H2II * HI / T(2.0)
                        + k19 * H2II * HM / T(2.0)
                        + k22 * HI * (HI * HI));
      acoef = k13 * HI + k11 * HII + k12 * de + s29 + s31;
      if (dust) scoef = scoef + T(2.0) * h2dust * HI * rhoH;
      H2Ip = (scoef * dtit + H2I) / (T(1.0) + acoef * dtit);

      // H-
      scoef = k7 * HI * de;
      acoef = (k8 + k15) * HI
          + (k16 + k17) * HII
          + k14 * de + k19 * H2II / T(2.0)
          + s27;
      HMp = (scoef * dtit + HM) / (T(1.0) + acoef * dtit);

      // H2+ (algebraic equilibrium; F:2293-2301)
      H2IIp = T(2.0) * (k9 * HIp * HIIp
                        + k11 * H2Ip / T(2.0) * HIIp
                        + k17 * HMp * HIIp
                        + s29 * H2Ip)
          / (k10 * HIp + k18 * dep + k19 * HMp + (s28 + s30));
    }

    if (isp > 2) {
      // deuterium network (F:2310-2360)
      const T k50 = ld<T>(a, i, I_k50), k51 = ld<T>(a, i, I_k51);
      const T k52 = ld<T>(a, i, I_k52), k53 = ld<T>(a, i, I_k53);
      const T k54 = ld<T>(a, i, I_k54), k55 = ld<T>(a, i, I_k55);
      const T k56 = ld<T>(a, i, I_k56);
      T xfer1 = k1 * de + k50 * HII + s24;
      if (irt) xfer1 = xfer1 + kphHI;
      const T leak1 = k54 * H2I / T(2.0) + k56 * HM;
      const T c1 = T(2.0) * k55 * HDI * HI / T(3.0);
      const T xfer2 = k2 * de + k51 * HI;
      const T leak2 = k52 * H2I / T(2.0);
      const T c2 = T(2.0) * k53 * HII * HDI / T(3.0);
      if (a.deuterium_coupled == 1) {
        const T a1 = xfer1 + leak1;
        const T a2 = xfer2 + leak2;
        const T det = (T(1.0) + a1 * dtit) * (T(1.0) + a2 * dtit)
            - (xfer1 * dtit) * (xfer2 * dtit);
        DIp = ((DI + c1 * dtit) * (T(1.0) + a2 * dtit)
               + xfer2 * dtit * (DII + c2 * dtit)) / det;
        DIIp = ((DII + c2 * dtit) * (T(1.0) + a1 * dtit)
                + xfer1 * dtit * (DI + c1 * dtit)) / det;
      } else {
        scoef = xfer2 * DII + c1;
        acoef = xfer1 + leak1;
        DIp = (scoef * dtit + DI) / (T(1.0) + acoef * dtit);
        scoef = xfer1 * DI + c2;
        acoef = xfer2 + leak2;
        DIIp = (scoef * dtit + DII) / (T(1.0) + acoef * dtit);
      }
      scoef = T(3.0) * (k52 * DII * H2I / T(2.0) / T(2.0)
                        + k54 * DI * H2I / T(2.0) / T(2.0)
                        + T(2.0) * k56 * DI * HM / T(2.0));
      acoef = k53 * HII + k55 * HI;
      HDIp = (scoef * dtit + HDI) / (T(1.0) + acoef * dtit);
    }

    // write back with floors (F:2364-2396)
    const T dtit_floor = tmax(dtit, tiny8);
    const T HIdot_new = tabs(HI - HIp) / dtit_floor;
    const T HI_o = tmax(HIp, tiny);
    const T HII_o = tmax(HIIp, tiny);
    const T HeI_o = tmax(HeIp, tiny);
    const T HeII_o = tmax(HeIIp, tiny);
    const T HeIII_o = tmax(HeIIIp, T(1.0e-5 * 1.0e-20));
    T HM_o = 0, H2I_o = 0, H2II_o = 0;
    if (isp > 1) {
      HM_o = tmax(HMp, tiny);
      H2I_o = tmax(H2Ip, tiny);
      H2II_o = tmax(H2IIp, tiny);
    }
    // electron density from charge conservation (F:2376-2384)
    T de_o = HII_o + HeII_o / T(4.0) + HeIII_o / T(2.0);
    if (isp > 1) de_o = de_o - HM_o + H2II_o / T(2.0);
    const T dedot_new = tabs(de_o - de) / dtit_floor;

    st<T>(a, i, O_de, itmask ? de_o : de);
    st<T>(a, i, O_HI, itmask ? HI_o : HI);
    st<T>(a, i, O_HII, itmask ? HII_o : HII);
    st<T>(a, i, O_HeI, itmask ? HeI_o : HeI);
    st<T>(a, i, O_HeII, itmask ? HeII_o : HeII);
    st<T>(a, i, O_HeIII, itmask ? HeIII_o : HeIII);
    if (isp > 1) {
      st<T>(a, i, O_HM, itmask ? HM_o : HM);
      st<T>(a, i, O_H2I, itmask ? H2I_o : H2I);
      st<T>(a, i, O_H2II, itmask ? H2II_o : H2II);
    }
    if (isp > 2) {
      st<T>(a, i, O_DI, itmask ? tmax(DIp, tiny) : DI);
      st<T>(a, i, O_DII, itmask ? tmax(DIIp, tiny) : DII);
      st<T>(a, i, O_HDI, itmask ? tmax(HDIp, tiny) : HDI);
    }
    st<T>(a, i, O_dedot_prev,
          itmask ? dedot_new : ld<T>(a, i, I_dedot_prev));
    st<T>(a, i, O_HIdot_prev,
          itmask ? HIdot_new : ld<T>(a, i, I_HIdot_prev));
  } else {
    // tabulated mode: no species, the rate history passes through
    st<T>(a, i, O_dedot_prev, ld<T>(a, i, I_dedot_prev));
    st<T>(a, i, O_HIdot_prev, ld<T>(a, i, I_HIdot_prev));
  }

  // advance cell clocks and retire finished cells (F:803-813)
  T ttot_new, ttot_lo_new = T(0);
  bool unfinished;
  if (comp) {
    T t_hi, t_lo;
    two_sum(ttot, ttot_lo, itmask ? dtit : dt, t_hi, t_lo);
    // once the compensated clock reaches dt the pair snaps to (dt, 0)
    const bool done = (t_hi + t_lo) >= dt;
    ttot_new = done ? dt : t_hi;
    ttot_lo_new = done ? T(0.0) : t_lo;
    unfinished =
        tabs((dt - ttot_new) - ttot_lo_new) >= T(a.tolerance * dt64);
    st<T>(a, i, O_ttot_lo, ttot_lo_new);
  } else {
    ttot_new = tmin(ttot + (itmask ? dtit : dt), dt);
    unfinished = tabs(dt - ttot_new) >= T(a.tolerance * dt64);
  }
  const int it_new = it + (itmask ? 1 : 0);
  const bool hit_cap = it_new >= a.max_iterations;
  st<T>(a, i, O_ttot, ttot_new);
  st<int>(a, i, O_cell_it, it_new);
  st<uint8_t>(a, i, O_itmask, (itmask && unfinished && !hit_cap) ? 1 : 0);
  st<uint8_t>(a, i, O_capped,
              (capped || (itmask && unfinished && hit_cap)) ? 1 : 0);
  st<T>(a, i, O_tgasold,
        itmask ? ld<T>(a, i, I_cool_tgasold) : ld<T>(a, i, I_tgasold));
  st<T>(a, i, O_tdust,
        itmask ? ld<T>(a, i, I_cool_tdust) : ld<T>(a, i, I_tdust));
  st<T>(a, i, O_dtit_prev, itmask ? dtit : ld<T>(a, i, I_dtit_prev));
}

template <typename T>
__global__ void __launch_bounds__(TILE, MIN_CTAS_PER_SM<T>)
network_update_kernel(const __grid_constant__ NetworkArgs a) {
  const long long stride = (long long)gridDim.x * TILE;
  const double dt64 = __ldg(static_cast<const double*>(a.dt));
  Scalars<T> sc;
  sc.dom = __ldg(static_cast<const T*>(a.scalar[S_dom]));
  sc.chunit = __ldg(static_cast<const T*>(a.scalar[S_chunit]));
  sc.k27 = a.ispecies > 0 ? __ldg(static_cast<const T*>(a.scalar[S_k27]))
                          : T(0);
  for (long long i = (long long)blockIdx.x * TILE + threadIdx.x; i < a.n;
       i += stride) {
    network_cell<T>(a, i, dt64, sc);
  }
}

}  // namespace

extern "C" {

// Slot counts and the tile, so the Python wrapper can check its layout
// against this build's; returns the argument struct's size.
int grackle_network_slots(int* n_in, int* n_out, int* n_scalar, int* tile) {
  *n_in = N_IN;
  *n_out = N_OUT;
  *n_scalar = N_SCALAR;
  *tile = TILE;
  return (int)sizeof(NetworkArgs);
}

// Once per device: the SM count and how many CTAs of each kernel are
// resident on one SM.  Returns a CUDA error code (0 = ready).
int grackle_network_init(int* sms, int* ctas_f64, int* ctas_f32) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_f64, network_update_kernel<double>, TILE, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_f32, network_update_kernel<float>, TILE, 0);
  return (int)err;
}

// Launch args->grid CTAs on `stream` for float (is_double = 0) or double
// operands.  Returns cudaGetLastError() after the launch (0 = launched).
int grackle_network_update(const NetworkArgs* args, int is_double,
                           void* stream) {
  if (args->n <= 0) return 0;
  if (args->grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    network_update_kernel<double><<<args->grid, TILE, 0, s>>>(*args);
  } else {
    network_update_kernel<float><<<args->grid, TILE, 0, s>>>(*args);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
