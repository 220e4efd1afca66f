// Exact-bound Dormand-Prince kernels: every step clamps at every output
// bound, one thread per lane, from one templated body.
//
//   exact_kernel<T, false, false, I>
//                           one group of output bounds in one launch
//                           (rwrt_exact_group: solvers/rk45.py
//                           integrate_group on CUDA), with its suspend /
//                           resume state;
//   exact_kernel<T, true, kBarrier, I>
//                           the whole exact run in one launch
//                           (rwrt_exact_run: tracer._exact_run on CUDA).
//                           Each lane walks every group of bounds with each
//                           group's semantics and writes its rows straight
//                           into the run's (nt, 5, R) and (nt, R) (ug, vg)
//                           output.
//
// Replaces (rwrt_tpu, fused by XLA there, no Pallas original):
//   tracer.py:861-936 _run_rk45_grouped, exact branch (:916-922: the group
//   loop and the truncation count after each group) and tracer.py:201-233
//   _rk45_group_chunk; solvers/rk45.py:302-478 integrate_group (the
//   while_loop body: FSAL stages, the NaN-norm-accepts rule, the h update,
//   the clamp at each bound, the kill test at each crossing against the
//   lane's last saved position, (ug, vg) from the 7th-stage sample, the skip
//   of a dead lane's remaining bounds, the bound-per-trip walk of NaN-amp
//   lanes) with its entry state group_entry_state (rootless and dead lanes
//   prefilled and finished at entry). With one bound per group, max_iters
//   100,000 and kBarrier it is also tracer.py:824-856 _run_rk45, the
//   barrier path over integrate_interval: there a lane whose amp turns NaN
//   inside an interval keeps stepping its dynamics to the bound and is
//   frozen only at the next interval's entry, so under kBarrier "frozen"
//   (the NaN-amp walk) is decided once, at each group's entry, where the
//   grouped path decides it on every trip.
// Plain PyTorch versions: rwrt_tpu_torch/tracer.py _exact_run_plain and
// rwrt_tpu_torch/solvers/rk45.py _integrate_group_plain, whose expressions
// and order this follows; the Dormand-Prince arithmetic is dp45.cuh's,
// shared with the dense kernels.
//
// What bounds the whole run on an H100. Bytes: the output, 7 values per
// lane and row (0.40 GB in float32 for the default 90-day run's 1,081 rows
// of 6,615 rays before compaction), ~0.1 ms at 3.35 TB/s. Operations,
// counted from the sources: a step attempt is six RHS evaluations of ~182
// flops plus ~360 for the stage sums, error norm, controller and the 7th
// stage's (ug, vg); a crossing ~9 for the kill test's cheap bound. The real
// floor is latency: each lane is a serial chain of trips, each six
// dependent RHS evaluations, and every output bound costs a lane at least
// one trip, so the launch lasts at least the longest lane's trips over all
// groups times the latency of one trip. Exact mode has no pin-kill (the
// JAX package's config rejects one): a lane grinding near the step floor
// holds the launch as long as its chain lasts, up to max_iters trips a
// group.
//
// Design, as dense_run.cu's: the batch-wide XLA loop becomes a per-lane
// loop, one loop over trips and group changes (so the lanes of a warp that
// are stepping run each trip together, whichever group each is in), the
// stages in registers, the kill test only at a crossing and its haversine
// only where a cheap bound cannot rule the kill out (ray_rhs.cuh
// kill_mask). A row is written once: at its crossing; at a lane's entry
// prefill; or NaN at the group's end for the bounds a live lane never
// saved (killed, or cut short by max_iters). Blocks of 128 threads, as the
// other integrator kernels. The kernel is templated on the evaluation's
// instance (ray_rhs.cuh: Lane, Split), which the wrappers choose
// (solvers/rk45.py exact_instance): 8 threads per lane for the launches
// of some dozens to a few thousand lanes, one thread per lane elsewhere.
// A team's threads take the same branches on the same state, so exact
// mode's per-lane branching never splits a team; its first thread writes
// the rows and the carry.
//
// Rounding: built with -fmad=false (kernels/build.py), so each expression
// rounds as the plain version's separate tensor ops do.
//
// Equivalence with the batch-wide loop: a lane is active on a prefix of the
// JAX loop's trips, so stopping each lane after max_iters of its own trips
// (walk trips included) is the JAX max_iters backstop, and iters = max over
// lanes of its trips.
#include <cuda_runtime.h>

#include "dp45.cuh"

namespace {

using rwrt::dp45::nan_max;

template <typename T>
struct ExactArgs {
  rwrt::Background<T> bg;
  // Carry, (5, R) / (R,): read at entry, written at exit. The whole run
  // enters with t = 0 and takes its last saved position from y.
  T* y;
  T* t;
  T* h;
  T* f;
  T* plon;
  T* plat;
  int* lane_att;  // (n_groups, R): step attempts per group
  // Single group: the controller flags, the next bound and the attempts,
  // read at entry on resume; written at exit; and the trips per lane.
  bool* rejected;
  bool* new_step;
  int* idx;
  int* trips;
  bool resume;
  // Single group: hist (G, 7, R), rows [state, ug, vg] per bound. Whole
  // run: hist (n_groups * G + 1, 5, R), row 0 the entry state, row
  // 1 + g * G + b bound b of group g, and (ug, vg) in ugs, vgs
  // (n_groups * G + 1, R).
  T* hist;
  T* ugs;
  T* vgs;
  const T* ug0;  // whole run: row 0 of (ug, vg)
  const T* vg0;
  int* trunc;    // whole run: groups the backstop left the live lane short
  const T* bounds;  // (n_groups, G), non-decreasing within a group
  int G;
  int n_groups;
  int R;
  T cut_off, rtol, atol, min_step;
  long long max_iters;
};

template <typename T, bool kRun, bool kBarrier, class I>
__global__ void __launch_bounds__(rwrt::kBlock)
    exact_kernel(const ExactArgs<T> a) {
  static_assert(kRun || !kBarrier, "barrier semantics are a run's");
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / I::kThreads;
  if (i >= a.R) return;
  const bool lead = I::lead();
  const long long RL = a.R;
  const int G = a.G;
  const T nan = rwrt::nan_value<T>();

  T yl[5], fl[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    yl[v] = a.y[v * RL + i];
    fl[v] = a.f[v * RL + i];
  }
  T tl = a.t[i];
  T hl = a.h[i];
  T plon, plat;
  if constexpr (kRun) {
    plon = yl[0];
    plat = yl[1];
    if (lead) {
#pragma unroll
      for (int v = 0; v < 5; ++v) a.hist[v * RL + i] = yl[v];
      a.ugs[i] = a.ug0[i];
      a.vgs[i] = a.vg0[i];
    }
  } else {
    plon = a.plon[i];
    plat = a.plat[i];
  }

  // The current group g (-1 before the first): its bounds, final time, the
  // lane's next bound idx (G: finished), the next row to save, the
  // controller flags, attempts and trips.
  int g = -1;
  const T* bounds = a.bounds;
  T t_end = tl;
  int idx = 0;
  int nb = 0;
  bool rej = false;
  bool ns = true;
  bool frozen_g = false;  // kBarrier: the NaN-amp walk, fixed at entry
  int att = 0;
  long long trips = 0;
  int trunc = 0;
  auto store = [&](int b, const T row[5], T ug, T vg) {
    if (!lead) return;
    if constexpr (kRun) {
      const long long r = 1 + static_cast<long long>(g) * G + b;
#pragma unroll
      for (int v = 0; v < 5; ++v) a.hist[(r * 5 + v) * RL + i] = row[v];
      a.ugs[r * RL + i] = ug;
      a.vgs[r * RL + i] = vg;
    } else {
#pragma unroll
      for (int v = 0; v < 5; ++v) a.hist[(b * 7LL + v) * RL + i] = row[v];
      a.hist[(b * 7LL + 5) * RL + i] = ug;
      a.hist[(b * 7LL + 6) * RL + i] = vg;
    }
  };

  // ONE loop over the trips and the group changes.
  for (;;) {
    if (g < 0 || idx >= G || trips >= a.max_iters) {
      if (g >= 0) {
        // Close group g: the bounds a live lane never saved stay NaN (the
        // entry state's prefill).
        if (!a.resume) {
          const T row[5] = {nan, nan, nan, nan, nan};
          for (int b = nb; b < G; ++b) store(b, row, nan, nan);
        }
        // Counted after the group: a lane the backstop left short of the
        // group's final bound while alive.
        if constexpr (kRun) {
          if (tl < t_end && !isnan(yl[0])) ++trunc;
        }
        if (lead) a.lane_att[g * RL + i] = att;
      }
      if (++g == a.n_groups) break;
      // Open group g.
      bounds = a.bounds + static_cast<long long>(g) * G;
      t_end = __ldg(bounds + G - 1);
      trips = 0;
      if (a.resume) {
        rej = a.rejected[i];
        ns = a.new_step[i];
        att = a.lane_att[i];
        idx = a.idx[i];
      } else {
        // Entry state: a NaN in the dynamics rows (isnan(mean(y[:4])))
        // saves the unchanged state at every bound with NaN (ug, vg) and
        // finishes the lane.
        rej = false;
        ns = true;
        att = 0;
        idx = 0;
        nb = 0;
        if (isnan((yl[0] + yl[1] + yl[2] + yl[3]) / T(4))) {
          for (int b = 0; b < G; ++b) store(b, yl, nan, nan);
          idx = nb = G;
          tl = t_end;
        }
      }
      frozen_g =
          isnan(yl[4]) && !isnan((yl[0] + yl[1] + yl[2] + yl[3]) / T(4));
      continue;
    }

    // One trip toward bound idx of group g.
    const T bound = __ldg(bounds + idx);
    // A NaN amp with finite dynamics: walk to the bound, state unchanged,
    // attempts not counted.
    const bool frozen =
        kBarrier ? frozen_g
                 : isnan(yl[4]) &&
                       !isnan((yl[0] + yl[1] + yl[2] + yl[3]) / T(4));
    const T heff = ns ? nan_max(hl, a.min_step) : hl;
    T t_new = tl + heff;
    if (t_new > bound) t_new = bound;
    if (frozen) t_new = bound;
    const T hs = t_new - tl;

    T k[7][5];
#pragma unroll
    for (int v = 0; v < 5; ++v) k[0][v] = fl[v];
    T y_new[5];
    rwrt::dp45::trial<T, I>(a.bg, yl, hs, k, y_new);
    if (frozen) {
#pragma unroll
      for (int v = 0; v < 5; ++v) y_new[v] = yl[v];
    }
    // The 7th stage samples the state a crossing saves: its (ug, vg) are
    // the row's.
    bool e;
    T ug_new, vg_new;
    rwrt::ray_rhs<T, I>(a.bg, y_new, k[6], &e, &ug_new, &vg_new);
    T error_norm = rwrt::dp45::error_norm(k, hs, yl, y_new, a.atol, a.rtol);
    if (isnan(error_norm)) error_norm = T(0);

    const bool accept = (error_norm < T(1)) || frozen;
    T fac_acc, fac_rej;
    rwrt::dp45::step_factors(error_norm, rej, &fac_acc, &fac_rej);
    T h_next = accept ? hs * fac_acc : hs * fac_rej;
    if (frozen) h_next = hl;

    T t_out = accept ? t_new : tl;
    if (isnan(t_out)) t_out = bound;
    if (accept) {
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        yl[v] = y_new[v];
        fl[v] = k[6][v];
      }
    }
    if (accept && t_out >= bound) {
      // Crossing: the kill test against the last saved position; a killed
      // row is NaN (state and (ug, vg)) and so is the carry.
      if (rwrt::kill_mask(yl, plon, plat, a.cut_off)) {
#pragma unroll
        for (int v = 0; v < 5; ++v) yl[v] = nan;
        ug_new = vg_new = nan;
      }
      store(idx, yl, ug_new, vg_new);
      nb = idx + 1;
      plon = yl[0];
      plat = yl[1];
      // Dead after the crossing: skip the remaining bounds.
      idx = isnan(yl[0]) ? G : idx + 1;
    }
    tl = t_out;
    hl = h_next;
    if (!frozen) {
      rej = !accept;
      ns = accept;
      ++att;
    }
    ++trips;
  }

  if (!lead) return;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    a.y[v * RL + i] = yl[v];
    a.f[v * RL + i] = fl[v];
  }
  a.t[i] = tl;
  a.h[i] = hl;
  a.plon[i] = plon;
  a.plat[i] = plat;
  if constexpr (kRun) {
    a.trunc[i] = trunc;
  } else {
    a.rejected[i] = rej;
    a.new_step[i] = ns;
    a.idx[i] = idx;
    a.trips[i] = static_cast<int>(trips);
  }
}

template <typename T, bool kRun, bool kBarrier>
int launch_exact(const ExactArgs<T>& a, int inst, cudaStream_t stream) {
  // A whole run with no group still writes row 0.
  if (a.R <= 0 || a.G <= 0 || (!kRun && a.n_groups <= 0)) return cudaSuccess;
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::launch_as<I>(exact_kernel<T, kRun, kBarrier, I>, a, a.R,
                                 stream);
  });
}

template <typename T>
int exact_resident(int run, int inst, int* out) {
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return run ? rwrt::resident_threads(exact_kernel<T, true, false, I>,
                                              out)
               : rwrt::resident_threads(
                     exact_kernel<T, false, false, I>, out);
  });
}

template <typename T>
ExactArgs<T> exact_args(const void* packed, int W, int H, double lon0,
                        double lat0, double dx, double dy, void* y, void* t,
                        void* h, void* f, void* plon, void* plat,
                        void* lane_att, void* hist, const void* bounds, int G,
                        int n_groups, int R, double cut_off, double rtol,
                        double atol, double min_step, long long max_iters) {
  ExactArgs<T> a{};
  a.bg = rwrt::Background<T>{static_cast<const T*>(packed), W, H, T(lon0),
                             T(lat0), T(dx), T(dy)};
  a.y = static_cast<T*>(y);
  a.t = static_cast<T*>(t);
  a.h = static_cast<T*>(h);
  a.f = static_cast<T*>(f);
  a.plon = static_cast<T*>(plon);
  a.plat = static_cast<T*>(plat);
  a.lane_att = static_cast<int*>(lane_att);
  a.hist = static_cast<T*>(hist);
  a.bounds = static_cast<const T*>(bounds);
  a.G = G;
  a.n_groups = n_groups;
  a.R = R;
  a.cut_off = T(cut_off);
  a.rtol = T(rtol);
  a.atol = T(atol);
  a.min_step = T(min_step);
  a.max_iters = max_iters;
  return a;
}

}  // namespace

extern "C" {

#define RWRT_EXACT(SUFFIX, T)                                                 \
  int rwrt_exact_group_##SUFFIX(                                              \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, void* y, void* t, void* h, void* f, void* plon, void* plat,  \
      void* rejected, void* new_step, void* lane_att, void* idx, void* trips, \
      void* hist, const void* bounds, int G, int R, int resume,               \
      double cut_off, double rtol, double atol, double min_step,              \
      long long max_iters, int inst, void* stream) {                          \
    ExactArgs<T> a = exact_args<T>(packed, W, H, lon0, lat0, dx, dy, y, t, h, \
                                   f, plon, plat, lane_att, hist, bounds, G,  \
                                   1, R, cut_off, rtol, atol, min_step,       \
                                   max_iters);                                \
    a.rejected = static_cast<bool*>(rejected);                                \
    a.new_step = static_cast<bool*>(new_step);                                \
    a.idx = static_cast<int*>(idx);                                           \
    a.trips = static_cast<int*>(trips);                                       \
    a.resume = resume != 0;                                                   \
    return launch_exact<T, false, false>(a, inst,                             \
                                         static_cast<cudaStream_t>(stream));  \
  }                                                                           \
  int rwrt_exact_run_##SUFFIX(                                                \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, void* y, void* t, void* h, void* f, void* plon, void* plat,  \
      const void* ug0, const void* vg0, void* hist, void* ugs, void* vgs,     \
      void* lane_att, void* trunc, const void* bounds, int G, int n_groups,   \
      int R, double cut_off, double rtol, double atol, double min_step,       \
      long long max_iters, int barrier, int inst, void* stream) {             \
    ExactArgs<T> a = exact_args<T>(packed, W, H, lon0, lat0, dx, dy, y, t, h, \
                                   f, plon, plat, lane_att, hist, bounds, G,  \
                                   n_groups, R, cut_off, rtol, atol,          \
                                   min_step, max_iters);                      \
    a.ug0 = static_cast<const T*>(ug0);                                       \
    a.vg0 = static_cast<const T*>(vg0);                                       \
    a.ugs = static_cast<T*>(ugs);                                             \
    a.vgs = static_cast<T*>(vgs);                                             \
    a.trunc = static_cast<int*>(trunc);                                       \
    const auto s = static_cast<cudaStream_t>(stream);                         \
    return barrier ? launch_exact<T, true, true>(a, inst, s)                  \
                   : launch_exact<T, true, false>(a, inst, s);                \
  }                                                                           \
  int rwrt_exact_resident_##SUFFIX(int run, int inst, void* out) {            \
    return exact_resident<T>(run, inst, static_cast<int*>(out));              \
  }

// One precision per translation unit, so that the two compile in parallel
// (exact_run_f64.cu includes this file for the float64 entry points).
#ifndef RWRT_EXACT_F64
RWRT_EXACT(f32, float)
#else
RWRT_EXACT(f64, double)
#endif

#undef RWRT_EXACT

}  // extern "C"
