// The exact-bound Dormand-Prince integrator over ONE interval per lane, each
// lane from its own t to its own bound, in one launch: the RK45 re-run of
// termination.cause_labels (--report-exact's exact death causes).
//
//   interval_kernel<T, kTime, I>   rwrt_interval (and rwrt_interval_time
//                                  over a time-varying or ensemble
//                                  background): solvers/rk45.py
//                                  integrate_interval_rays on CUDA.
//
// Replaces (rwrt_tpu, fused by XLA there, no Pallas original):
//   diagnostics/termination.py:159-177 (the RK45 branch of cause_labels)
//   over solvers/rk45.py:130 integrate_interval (the while_loop body: the
//   NaN-entry rule, the FSAL stage at entry, the step floor on a new step,
//   the clamp at the bound, the NaN-norm-accepts rule, the h update and the
//   NaN-time rule) with max_iters 10,000. Plain PyTorch version:
//   rwrt_tpu_torch/solvers/rk45.py integrate_interval over
//   models/ray.py _rhs_core (_integrate_interval_plain), whose expressions
//   and order this follows; the Dormand-Prince arithmetic is dp45.cuh's,
//   the RHS ray_rhs.cuh's.
//
// Why one launch is exact. The plain loop's trip count is batch-wide, but a
// lane that is not done is active on every trip until it is done, so each
// lane ends after min(its own trips, max_iters) trips whatever the other
// lanes do. A per-lane loop capped at max_iters of the lane's own trips
// gives the same bits, and each lane's trips are the plain loop's lane_att.
//
// What bounds it on an H100. Each lane is a serial chain of trips, each
// trip six dependent RHS evaluations and the controller, so the launch lasts
// at least its longest lane's trips times one trip's latency (the chain
// floor): on the production-size --report-exact run two float32 lanes
// stall at the 10,000-trip cap (the float32 time carry, ROADMAP Queue 3).
// Operations: a trip is ~6 x 182 + 360 flops; bytes: the (5, R) state,
// t, h and the bound in and out, and one L2-resident row of the background
// per evaluation. Both are far below the chain.
//
// Design. The plain loop's six RHS launches and host sync per trip become
// one loop per lane in registers: the entry RHS, then trips until the lane
// reaches its bound or its cap. The evaluation spreads over threads as the
// exact kernels' does (ray_rhs.cuh: Lane, one thread a lane; Split, 8
// threads a lane, which shortens the chain by the divisions' latency), the
// wrapper choosing as rk45.exact_instance chooses; a team takes the same
// branches on the same state, and its first thread writes the lane. Blocks
// of 128 threads. Types <float, float> and <double, double>: the re-run
// takes the fields' dtype. The float64 controller's pow is PyTorch's,
// inline (pow64.cuh).
//
// Rounding: built with -fmad=false (kernels/build.py), so each expression
// rounds as the plain version's separate tensor ops do.
#include <cuda_runtime.h>

#include "dp45.cuh"

namespace {

using rwrt::dp45::nan_max;

template <typename T, bool kTime>
struct IntervalArgs {
  rwrt::Background<T, kTime> bg;
  T* y;  // (5, R): read at entry, written at exit
  T* t;  // (R,)
  T* h;  // (R,)
  const T* t_bound;  // (R,): each lane's bound
  int* trips;        // (R,): each lane's trips (the plain loop's lane_att)
  int R;
  T rtol, atol, min_step;
  long long max_iters;
};

template <typename T, bool kTime, class I>
__global__ void __launch_bounds__(rwrt::kBlock)
    interval_kernel(const IntervalArgs<T, kTime> a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / I::kThreads;
  if (i >= a.R) return;
  const auto& bg = rwrt::lane_background(a.bg, i);
  const long long RL = a.R;

  T yl[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) yl[v] = a.y[v * RL + i];
  T tl = a.t[i];
  T hl = a.h[i];
  const T tb = a.t_bound[i];
  // Entry: a NaN component (isnan(mean(y, 0))) finishes the lane at its
  // bound; a lane already at its bound is done.
  const bool nan_mean =
      isnan((yl[0] + yl[1] + yl[2] + yl[3] + yl[4]) / T(5));
  if (nan_mean) tl = tb;
  long long trips = 0;
  if (!nan_mean && !(tl >= tb)) {
    bool e;
    T fl[5];
    const T t0 = kTime ? tl : T(0);  // the entry stage's time
    rwrt::ray_rhs<T, I>(bg, yl, t0, fl, &e);
    bool rej = false;
    bool ns = true;
    while (trips < a.max_iters) {
      const T heff = ns ? nan_max(hl, a.min_step) : hl;
      T t_new = tl + heff;
      if (t_new > tb) t_new = tb;
      const T hs = t_new - tl;

      T k[7][5];
#pragma unroll
      for (int v = 0; v < 5; ++v) k[0][v] = fl[v];
      T y_new[5];
      rwrt::dp45::trial<T, T, I>(bg, yl, tl, hs, k, y_new);
      const T t7 = kTime ? t_new : T(0);  // the 7th stage's time
      rwrt::ray_rhs<T, I>(bg, y_new, t7, k[6], &e);
      T error_norm = rwrt::dp45::error_norm(k, hs, yl, y_new, a.atol, a.rtol);
      if (isnan(error_norm)) error_norm = T(0);

      const bool accept = error_norm < T(1);
      T fac_acc, fac_rej;
      rwrt::dp45::step_factors(error_norm, rej, &fac_acc, &fac_rej);
      const T h_next = accept ? hs * fac_acc : hs * fac_rej;
      if (accept) {
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          yl[v] = y_new[v];
          fl[v] = k[6][v];
        }
      }
      const T t_out = accept ? t_new : tl;
      tl = isnan(t_out) ? tb : t_out;
      hl = h_next;
      rej = !accept;
      ns = accept;
      ++trips;
      if (accept && tl >= tb) break;
    }
  }

  if (!I::lead()) return;
#pragma unroll
  for (int v = 0; v < 5; ++v) a.y[v * RL + i] = yl[v];
  a.t[i] = tl;
  a.h[i] = hl;
  a.trips[i] = static_cast<int>(trips);
}

template <typename T, bool kTime>
int run_interval(const rwrt::Background<T, kTime>& bg, void* y, void* t,
                 void* h, const void* t_bound, void* trips, int R,
                 double rtol, double atol, double min_step,
                 long long max_iters, int inst, void* stream) {
  if (R <= 0) return cudaSuccess;
  IntervalArgs<T, kTime> a{};
  a.bg = bg;
  a.y = static_cast<T*>(y);
  a.t = static_cast<T*>(t);
  a.h = static_cast<T*>(h);
  a.t_bound = static_cast<const T*>(t_bound);
  a.trips = static_cast<int*>(trips);
  a.R = R;
  a.rtol = T(rtol);
  a.atol = T(atol);
  a.min_step = T(min_step);
  a.max_iters = max_iters;
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::launch_as<I>(interval_kernel<T, kTime, I>, a, R,
                              static_cast<cudaStream_t>(stream));
  });
}

// Resident threads of the kernel (rk45.interval_instance's occupancy
// count).
template <typename T, bool kTime>
int interval_resident(int inst, int* out) {
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::resident_threads(interval_kernel<T, kTime, I>, out);
  });
}

}  // namespace

extern "C" {

#define RWRT_INTERVAL(SUFFIX, T)                                              \
  int rwrt_interval_##SUFFIX(                                                 \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, void* y, void* t, void* h, const void* t_bound, void* trips, \
      int R, double rtol, double atol, double min_step, long long max_iters,  \
      int inst, void* stream) {                                               \
    return run_interval<T, false>(                                            \
        rwrt::make_background<T>(packed, W, H, lon0, lat0, dx, dy), y, t, h,  \
        t_bound, trips, R, rtol, atol, min_step, max_iters, inst, stream);    \
  }                                                                           \
  int rwrt_interval_time_##SUFFIX(                                            \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, int nt, int timed, double t0, double tdt,                    \
      const void* member, void* y, void* t, void* h, const void* t_bound,     \
      void* trips, int R, double rtol, double atol, double min_step,          \
      long long max_iters, int inst, void* stream) {                          \
    return run_interval<T, true>(                                             \
        rwrt::make_background<T>(packed, W, H, lon0, lat0, dx, dy, nt, timed, \
                                 t0, tdt, member),                            \
        y, t, h, t_bound, trips, R, rtol, atol, min_step, max_iters, inst,    \
        stream);                                                              \
  }                                                                           \
  int rwrt_interval_resident_##SUFFIX(int inst, void* out) {                  \
    return interval_resident<T, false>(inst, static_cast<int*>(out));         \
  }                                                                           \
  int rwrt_interval_resident_time_##SUFFIX(int inst, void* out) {             \
    return interval_resident<T, true>(inst, static_cast<int*>(out));          \
  }

// One precision per translation unit, so that the two compile in parallel
// (interval_f64.cu includes this file).
#if defined(RWRT_INTERVAL_F64)
RWRT_INTERVAL(f64, double)
#else
RWRT_INTERVAL(f32, float)
#endif

#undef RWRT_INTERVAL

}  // extern "C"
