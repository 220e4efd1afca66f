// Dense-group kernel: free-stepping Dormand-Prince 5(4) with dense output
// over one group of output bounds, one thread per lane, the whole group in
// ONE launch.
//
// Replaces (rwrt_tpu, fused by XLA there, no Pallas original):
//   solvers/rk45.py integrate_group_dense: the while_loop body (FSAL
//   stages, error norm, accept/reject with the NaN-reject rule, the h
//   update, quartic DP_P emission into hist, both pin-kill arms) and its
//   entry state dense_entry_state (frozen lanes prefilled, t -> t_end).
// Plain PyTorch version: rwrt_tpu_torch/solvers/rk45.py
// _integrate_group_dense_plain, whose expressions and order this follows.
//
// What bounds it on an H100: every trip costs six RHS evaluations, each a
// dependent 48-value gather from the ~2 MB packed background (read-only,
// shared by all lanes, L2-resident) plus ~150 flops; state I/O is small and
// once per launch. So a trip is bound by gather latency and instruction throughput, and the
// kernel's time is the slowest lane of each warp: lanes loop to their own
// end, so a warp runs as long as its worst straggler (pin-kill caps that
// at pin_limit trips per group). Register pressure comes from the seven
// stage vectors (35 values) plus the state; in float64 that is ~70 of the
// 255 registers a thread may hold. Design: the batch-wide XLA loop
// becomes a per-lane loop, so a finished lane costs nothing but its warp
// slot and no launch is spent per trip; the stages stay in registers; the
// background is read through the read-only cache; emission walks a pointer
// over the (non-decreasing) bounds instead of testing all G every trip.
//
// Rounding: built with -fmad=false (kernels/build.py), so each expression
// rounds as the plain version's separate tensor ops do; with FMA
// contraction the one-ulp differences were amplified by the error
// controller into different step sequences on most lanes.
//
// Equivalence with the batch-wide loop: a lane is active on a prefix of
// the JAX loop's trips, so stopping each lane after max_iters of its own
// trips is the JAX max_iters backstop, and iters = max over lanes of
// lane_att.
#include <cuda_runtime.h>

#include "ray_rhs.cuh"

namespace {

constexpr double kSafety = 0.9;
constexpr double kMinFactor = 0.2;
constexpr double kMaxFactor = 10.0;
constexpr double kErrorExponent = -0.2;

// jnp.maximum / jnp.minimum: NaN-propagating (fmax/fmin are not).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (isnan(a) || isnan(b)) ? rwrt::nan_value<T>() : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (isnan(a) || isnan(b)) ? rwrt::nan_value<T>() : (a < b ? a : b);
}

template <typename T>
__global__ void __launch_bounds__(128)
dense_group_kernel(rwrt::Background<T> bg, T* __restrict__ y,
                   T* __restrict__ t, T* __restrict__ h, T* __restrict__ f,
                   bool* __restrict__ rejected, bool* __restrict__ new_step,
                   int* __restrict__ lane_att, T* __restrict__ hist,
                   const T* __restrict__ bounds, int G, int R, T rtol,
                   T atol, T min_step, long long max_iters,
                   long long pin_limit, T pin_mwn) {
  // Dormand-Prince 5(4) tableau and dense-output quartic (solvers/rk45.py
  // DP_*), double literals rounded to T where used, as the JAX package's
  // weakly typed constants are. Local constexpr arrays, so the unrolled
  // loops index them at compile time.
  constexpr double kA[6][5] = {
      {0.0, 0.0, 0.0, 0.0, 0.0},
      {1.0 / 5, 0.0, 0.0, 0.0, 0.0},
      {3.0 / 40, 9.0 / 40, 0.0, 0.0, 0.0},
      {44.0 / 45, -56.0 / 15, 32.0 / 9, 0.0, 0.0},
      {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729, 0.0},
      {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176,
       -5103.0 / 18656},
  };

  constexpr double kB[6] = {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192,
                            -2187.0 / 6784, 11.0 / 84};
  constexpr double kE[7] = {-71.0 / 57600,  0.0,         71.0 / 16695,
                            -71.0 / 1920,   17253.0 / 339200,
                            -22.0 / 525,    1.0 / 40};
  constexpr double kP[7][4] = {
      {1.0, -8048581381.0 / 2820520608, 8663915743.0 / 2820520608,
       -12715105075.0 / 11282082432},
      {0.0, 0.0, 0.0, 0.0},
      {0.0, 131558114200.0 / 32700410799, -68118460800.0 / 10900136933,
       87487479700.0 / 32700410799},
      {0.0, -1754552775.0 / 470086768, 14199869525.0 / 1410260304,
       -10690763975.0 / 1880347072},
      {0.0, 127303824393.0 / 49829197408, -318862633887.0 / 49829197408,
       701980252875.0 / 199316789632},
      {0.0, -282668133.0 / 205662961, 2019193451.0 / 616988883,
       -1453857185.0 / 822651844},
      {0.0, 40617522.0 / 29380423, -110615467.0 / 29380423,
       69997945.0 / 29380423},
  };

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const long long RL = R;
  const T nan = rwrt::nan_value<T>();
  const T t_end = __ldg(bounds + G - 1);

  T yl[5], fl[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    yl[v] = y[v * RL + i];
    fl[v] = f[v * RL + i];
  }
  T tl = t[i];
  T hl = h[i];

  // Entry state: any NaN component (isnan(mean(y))) freezes the lane at
  // its entry state for every bound; live lanes' slots start NaN.
  const bool frozen = isnan((yl[0] + yl[1] + yl[2] + yl[3] + yl[4]) / T(5));
  for (int b = 0; b < G; ++b) {
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      hist[(static_cast<long long>(b) * 5 + v) * RL + i] =
          frozen ? yl[v] : nan;
    }
  }
  if (frozen) tl = t_end;
  bool rej = false;
  bool ns = true;
  int att = 0;
  // First bound strictly after t (bounds are non-decreasing).
  int nb = 0;
  while (nb < G && !(__ldg(bounds + nb) > tl)) ++nb;

  const T floor_thr = min_step * T(1.0 + 1e-6);
  for (long long it = 0; it < max_iters; ++it) {
    if (!(tl < t_end)) break;
    const T heff = ns ? nan_max(hl, min_step) : hl;
    const T t_new = nan_min(tl + heff, t_end);
    const T hs = t_new - tl;

    T k[7][5];
#pragma unroll
    for (int v = 0; v < 5; ++v) k[0][v] = fl[v];
    bool e;
#pragma unroll
    for (int s = 1; s < 6; ++s) {
      T ys[5];
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        T acc = T(0);
        bool first = true;
#pragma unroll
        for (int j = 0; j < s; ++j) {
          if (kA[s][j] != 0.0) {
            T term = T(kA[s][j]) * k[j][v];
            acc = first ? term : acc + term;
            first = false;
          }
        }
        ys[v] = yl[v] + hs * acc;
      }
      rwrt::ray_rhs(bg, ys, k[s], &e);
    }
    T y_new[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      T acc = T(kB[0]) * k[0][v];
#pragma unroll
      for (int j = 1; j < 6; ++j) acc = acc + T(kB[j]) * k[j][v];
      y_new[v] = yl[v] + hs * acc;
    }
    rwrt::ray_rhs(bg, y_new, k[6], &e);

    T sq = T(0);
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      T acc = T(kE[0]) * k[0][v];
#pragma unroll
      for (int j = 1; j < 7; ++j) acc = acc + T(kE[j]) * k[j][v];
      const T err = hs * acc;
      const T scale = atol + nan_max(fabs(yl[v]), fabs(y_new[v])) * rtol;
      const T x = err / scale;
      sq = (v == 0) ? x * x : sq + x * x;
    }
    const T error_norm = sqrt(sq / T(5));

    const bool nan_err = isnan(error_norm);
    const bool dead_now = isnan(yl[0]);
    const bool at_floor = hs <= min_step;
    const bool accept = nan_err ? (dead_now || at_floor) : (error_norm < T(1));
    const T raw = T(kSafety) * pow(error_norm, T(kErrorExponent));
    T fac_acc = nan_min(T(kMaxFactor), raw);
    if (rej) fac_acc = nan_min(T(1), fac_acc);
    if (nan_err) fac_acc = T(1);
    T fac_rej = nan_max(T(kMinFactor), raw);
    if (nan_err) fac_rej = T(kMinFactor);
    const T h_next = accept ? hs * fac_acc : hs * fac_rej;

    if (accept) {
      // Dense emission: every bound in (t, t_new] from the quartic
      // interpolant of this step's stages.
      const T hden = (hs == T(0)) ? T(1) : hs;
      while (nb < G) {
        const T bnd = __ldg(bounds + nb);
        if (!(bnd <= t_new)) break;
        const T th = (bnd - tl) / hden;
        T bp[7];
#pragma unroll
        for (int q = 0; q < 7; ++q) {
          bp[q] = th * (T(kP[q][0]) +
                        th * (T(kP[q][1]) +
                              th * (T(kP[q][2]) + th * T(kP[q][3]))));
        }
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          T acc = bp[0] * k[0][v];
#pragma unroll
          for (int q = 1; q < 7; ++q) acc = acc + bp[q] * k[q][v];
          hist[(static_cast<long long>(nb) * 5 + v) * RL + i] =
              yl[v] + hs * acc;
        }
        ++nb;
      }
    }

    T y_out[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) y_out[v] = accept ? y_new[v] : yl[v];
    T t_out = accept ? t_new : tl;

    // Straggler pin-kill: accepted steps and rejections at the step floor.
    att += 1;
    const bool floor_rej = !accept && (hs <= floor_thr);
    // The pin row is ky (state row 3), as in the plain version.
    const bool retire = (accept || floor_rej) &&
                        (static_cast<long long>(att) >= pin_limit) &&
                        (fabs(y_out[3]) >= pin_mwn);
    if (retire) {
#pragma unroll
      for (int v = 0; v < 5; ++v) y_out[v] = nan;
    }
    // Lanes whose state went NaN finish at once.
    if (isnan(y_out[0])) t_out = t_end;

    if (accept) {
#pragma unroll
      for (int v = 0; v < 5; ++v) fl[v] = k[6][v];
    }
#pragma unroll
    for (int v = 0; v < 5; ++v) yl[v] = y_out[v];
    tl = t_out;
    hl = h_next;
    rej = !accept;
    ns = accept;
  }

#pragma unroll
  for (int v = 0; v < 5; ++v) {
    y[v * RL + i] = yl[v];
    f[v * RL + i] = fl[v];
  }
  t[i] = tl;
  h[i] = hl;
  rejected[i] = rej;
  new_step[i] = ns;
  lane_att[i] = att;
}

template <typename T>
int launch_dense_group(const T* packed, int W, int H, double lon0,
                       double lat0, double dx, double dy, T* y, T* t, T* h,
                       T* f, bool* rejected, bool* new_step, int* lane_att,
                       T* hist, const T* bounds, int G, int R, double rtol,
                       double atol, double min_step, long long max_iters,
                       long long pin_limit, double pin_mwn,
                       cudaStream_t stream) {
  if (R <= 0 || G <= 0) return cudaSuccess;
  rwrt::Background<T> bg{packed, W, H, T(lon0), T(lat0), T(dx), T(dy)};
  const int block = 128;
  const int grid = (R + block - 1) / block;
  dense_group_kernel<T><<<grid, block, 0, stream>>>(
      bg, y, t, h, f, rejected, new_step, lane_att, hist, bounds, G, R,
      T(rtol), T(atol), T(min_step), max_iters, pin_limit, T(pin_mwn));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define RWRT_DENSE_GROUP(SUFFIX, T)                                          \
  int rwrt_dense_group_##SUFFIX(                                             \
      const void* packed, int W, int H, double lon0, double lat0, double dx, \
      double dy, void* y, void* t, void* h, void* f, void* rejected,         \
      void* new_step, void* lane_att, void* hist, const void* bounds, int G, \
      int R, double rtol, double atol, double min_step, long long max_iters, \
      long long pin_limit, double pin_mwn, void* stream) {                   \
    return launch_dense_group<T>(                                            \
        static_cast<const T*>(packed), W, H, lon0, lat0, dx, dy,             \
        static_cast<T*>(y), static_cast<T*>(t), static_cast<T*>(h),          \
        static_cast<T*>(f), static_cast<bool*>(rejected),                    \
        static_cast<bool*>(new_step), static_cast<int*>(lane_att),           \
        static_cast<T*>(hist), static_cast<const T*>(bounds), G, R, rtol,    \
        atol, min_step, max_iters, pin_limit, pin_mwn,                       \
        static_cast<cudaStream_t>(stream));                                  \
  }

RWRT_DENSE_GROUP(f32, float)
RWRT_DENSE_GROUP(f64, double)

#undef RWRT_DENSE_GROUP

}  // extern "C"
