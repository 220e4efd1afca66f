// Exact-bound Dormand-Prince kernels: every step clamps at every output
// bound, one thread (or team) per lane, from one set of lane functions
// (exact_start, exact_iterate, exact_finish).
//
//   exact_kernel<S, F, false, false, kTime, I>
//                           one group of output bounds in one launch
//                           (rwrt_exact_group: solvers/rk45.py
//                           integrate_group on CUDA), with its suspend /
//                           resume state;
//   exact_kernel<float, float, true, kBarrier, kTime, I>
//   exact_run_kernel<double, F, kBarrier, kTime, I>
//                           the whole exact run in one launch
//                           (rwrt_exact_run: tracer._exact_run on CUDA):
//                           in float32 each lane to its end in launch
//                           order; with a float64 state (F double, or
//                           float in mixed precision) live lanes repacked
//                           into full warps on a persistent grid. Each lane
//                           walks every group of bounds with each group's
//                           semantics and writes its rows straight into the
//                           run's (nt, 5, R) and (nt, R) (ug, vg) output.
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
// saved (killed, or cut short by max_iters). The kernels are templated on
// the evaluation's instance (ray_rhs.cuh: Lane, Split), which the wrappers
// choose (solvers/rk45.py exact_instance, by lane count and dtypes): 8
// threads per lane for the launches of some dozens to some thousands of
// lanes, one thread per lane elsewhere. A team's threads take the same
// branches on the same state, so exact mode's per-lane branching never
// splits a team; its first thread writes the rows and the carry.
//
// The launch-order kernels run blocks of 128 threads, as the other
// integrator kernels. The float64-state whole run repacks (repack.cuh
// run_lanes, the dense kernel's design): lanes differ in their trips per
// group, and a killed lane skips its remaining bounds, so in launch order
// a warp's finished lanes idle while its slowest runs, and on FP64 pipes
// that idle issue is the launch's time; and a launch larger than the card
// keeps resident waits for a tail wave. A persistent grid of blocks of
// kRunBlock threads (tracer.exact_grid) deals the lanes, queues the rest,
// and repacks whole lanes (whole teams) into the lowest threads on the
// schedule tracer.EXACT_SCHEDULE gives the dtypes. Rows, (ug, vg),
// lane_att, trunc and the carry are addressed by the lane's index, and a
// lane's arithmetic is in its order whichever thread runs it. A team over
// a float64 state also does its per-variable float64 work once (dp45.cuh
// spreads): each of its first five threads takes one state variable's
// stage sums, trial state and error-norm term, threads 0 and 1 the kill
// test's haversine terms (ray_rhs.cuh kill_mask), and shuffles give every
// thread the results, where the launch-order team computed each on all
// eight threads. The single group and the float32 whole run keep their
// launch order and their team's work (their launches are short, or their
// FP32 pipes not the limit).
//
// Types: the state S (y, t, h, the controller, the kill test, the rows)
// and the background F (the RHS, the stages k and the FSAL carry f):
// <T, T, ...> is the one-type kernel; exact_run_kernel<double, float,
// kBarrier, kTime, I> the mixed-precision whole run and
// exact_kernel<double, float, false, false, kTime, I> its single group (the
// _mix entry points, compiled in exact_run_mix.cu). The Dormand-Prince casts are
// dp45.cuh's. The (ug, vg) of a
// row are the 7th stage's F sample, widened, as the JAX package's grouped
// path has them; under kBarrier in mixed precision they are sampled at
// the saved state in S instead (ray_rhs.cuh group_velocity_at<S, F>), as
// its barrier path has them (tracer.py _rk45_chunk). With S == F the two
// are the same values, and the one-type kernels keep the stage's.
//
// Time: a trial's stages sample at t + c_s h (dp45.cuh trial) and its 7th
// stage at t + h; under kGvAtSave the saved state's (ug, vg) at that time
// too, as the plain versions pass them. Only the time instances (kTime:
// exact_run_time*.cu, the whole run and the single group over a
// time-varying or ensemble background, ray_rhs.cuh) read the time; the
// static instances' code is the code without it.
//
// Rounding: built with -fmad=false (kernels/build.py), so each expression
// rounds as the plain version's separate tensor ops do.
//
// Equivalence with the batch-wide loop: a lane is active on a prefix of the
// JAX loop's trips, so stopping each lane after max_iters of its own trips
// (walk trips included) is the JAX max_iters backstop, and iters = max over
// lanes of its trips.
#include <cuda_runtime.h>

#include <type_traits>

#include "dp45.cuh"
#include "repack.cuh"

namespace {

using rwrt::dp45::nan_max;

template <typename S, typename F, bool kTime>
struct ExactArgs {
  rwrt::Background<F, kTime> bg;
  // Carry, (5, R) / (R,): read at entry, written at exit. The whole run
  // enters with t = 0 and takes its last saved position from y.
  S* y;
  S* t;
  S* h;
  F* f;
  S* plon;
  S* plat;
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
  S* hist;
  S* ugs;
  S* vgs;
  const S* ug0;  // whole run: row 0 of (ug, vg)
  const S* vg0;
  int* trunc;    // whole run: groups the backstop left the live lane short
  const S* bounds;  // (n_groups, G), non-decreasing within a group
  int G;
  int n_groups;
  int R;
  S cut_off, rtol, atol, min_step;
  long long max_iters;
  // Whole run with a float64 state (repacked): the lane queue's counter
  // (one int, zero at launch), the most loop iterations between two
  // repacks, and the lanes that, once they have left the block, end a
  // window early.
  int* queue;
  int every;
  int trigger;
};

// Threads per block of the repacked whole run (a float64 state): the
// widest block whose registers fit one SM (65,536), as the dense kernel's
// (dense_run.cu RunBlock): at most 255 registers a thread, 32 lanes of a
// team instance.
constexpr int kRunBlock = 256;

// One lane's carry between loop iterations: the state and FSAL stage, the
// controller, the current group g (-1 before the first) with its bounds
// and final time, the next bound idx (G: finished), the next row to save
// nb, the attempts and trips in g, the truncation count, the last saved
// position and (under kBarrier) the NaN-amp walk fixed at g's entry.
template <typename S, typename F>
struct ExactLane {
  S y[5];
  F f[5];
  S t, h, t_end, plon, plat;
  const S* bounds;
  long long trips;
  int i, g, idx, nb, att, trunc;
  bool rej, ns, frozen_g;
};

// Lane i enters from the carry (and, in the whole run, writes its row 0).
template <bool kRun, class I, typename S, typename F, bool kTime>
__device__ __forceinline__ void exact_start(const ExactArgs<S, F, kTime>& a,
                                            int i, ExactLane<S, F>& L) {
  const long long RL = a.R;
  L.i = i;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    L.y[v] = a.y[v * RL + i];
    L.f[v] = a.f[v * RL + i];
  }
  L.t = a.t[i];
  L.h = a.h[i];
  if constexpr (kRun) {
    L.plon = L.y[0];
    L.plat = L.y[1];
    if (I::lead()) {
#pragma unroll
      for (int v = 0; v < 5; ++v) a.hist[v * RL + i] = L.y[v];
      a.ugs[i] = a.ug0[i];
      a.vgs[i] = a.vg0[i];
    }
  } else {
    L.plon = a.plon[i];
    L.plat = a.plat[i];
  }
  L.g = -1;
  L.bounds = a.bounds;
  L.t_end = L.t;
  L.idx = 0;
  L.nb = 0;
  L.rej = false;
  L.ns = true;
  L.frozen_g = false;
  L.att = 0;
  L.trips = 0;
  L.trunc = 0;
}

// One iteration of lane L's loop: a trip toward its next bound, or the
// change from one group to the next. Returns true when the lane has closed
// its last group. The lanes of a warp that are stepping run each trip
// together, whichever group each is in.
template <bool kRun, bool kBarrier, class I, typename S, typename F,
          bool kTime, typename BG>
__device__ __forceinline__ bool exact_iterate(const ExactArgs<S, F, kTime>& a,
                                              const BG& bg,
                                              ExactLane<S, F>& L) {
  static_assert(kRun || !kBarrier, "barrier semantics are a run's");
  // The barrier path's mixed-precision (ug, vg): sampled at the saved
  // state in S (see the head of this file).
  constexpr bool kGvAtSave = kBarrier && !std::is_same<S, F>::value;
  // A team over a float64 state spreads its per-variable work (dp45.cuh)
  // in the whole run, and the kill test's haversine with it.
  constexpr bool kSpread = kRun && rwrt::dp45::kSpreads<S, I>;
  using KillI = std::conditional_t<kSpread, I, rwrt::Lane>;
  const bool lead = I::lead();
  const long long RL = a.R;
  const int G = a.G;
  const int i = L.i;
  const S nan = rwrt::nan_value<S>();
  auto store = [&](int b, const S row[5], S ug, S vg) {
    if (!lead) return;
    if constexpr (kRun) {
      const long long r = 1 + static_cast<long long>(L.g) * G + b;
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

  if (L.g < 0 || L.idx >= G || L.trips >= a.max_iters) {
    if (L.g >= 0) {
      // Close group g: the bounds a live lane never saved stay NaN (the
      // entry state's prefill).
      if (!a.resume) {
        const S row[5] = {nan, nan, nan, nan, nan};
        for (int b = L.nb; b < G; ++b) store(b, row, nan, nan);
      }
      // Counted after the group: a lane the backstop left short of the
      // group's final bound while alive.
      if constexpr (kRun) {
        if (L.t < L.t_end && !isnan(L.y[0])) ++L.trunc;
      }
      if (lead) a.lane_att[L.g * RL + i] = L.att;
    }
    if (++L.g == a.n_groups) return true;
    // Open group g.
    L.bounds = a.bounds + static_cast<long long>(L.g) * G;
    L.t_end = __ldg(L.bounds + G - 1);
    L.trips = 0;
    if (a.resume) {
      L.rej = a.rejected[i];
      L.ns = a.new_step[i];
      L.att = a.lane_att[i];
      L.idx = a.idx[i];
    } else {
      // Entry state: a NaN in the dynamics rows (isnan(mean(y[:4])))
      // saves the unchanged state at every bound with NaN (ug, vg) and
      // finishes the lane.
      L.rej = false;
      L.ns = true;
      L.att = 0;
      L.idx = 0;
      L.nb = 0;
      if (isnan((L.y[0] + L.y[1] + L.y[2] + L.y[3]) / S(4))) {
        for (int b = 0; b < G; ++b) store(b, L.y, nan, nan);
        L.idx = L.nb = G;
        L.t = L.t_end;
      }
    }
    L.frozen_g = isnan(L.y[4]) &&
                 !isnan((L.y[0] + L.y[1] + L.y[2] + L.y[3]) / S(4));
    return false;
  }

  // One trip toward bound idx of group g.
  const S bound = __ldg(L.bounds + L.idx);
  // A NaN amp with finite dynamics: walk to the bound, state unchanged,
  // attempts not counted.
  const bool frozen =
      kBarrier ? L.frozen_g
               : isnan(L.y[4]) &&
                     !isnan((L.y[0] + L.y[1] + L.y[2] + L.y[3]) / S(4));
  const S heff = L.ns ? nan_max(L.h, a.min_step) : L.h;
  S t_new = L.t + heff;
  if (t_new > bound) t_new = bound;
  if (frozen) t_new = bound;
  const S hs = t_new - L.t;

  F k[7][5];
#pragma unroll
  for (int v = 0; v < 5; ++v) k[0][v] = L.f[v];
  S y_new[5];
  rwrt::dp45::Own<S, F> own;
  rwrt::dp45::trial<S, F, I, kTime, kSpread>(bg, L.y, L.t, hs, k, y_new,
                                             &own);
  if (frozen) {
#pragma unroll
    for (int v = 0; v < 5; ++v) y_new[v] = L.y[v];
    if constexpr (kSpread) own.y_new = own.y;
  }
  // The 7th stage samples the state a crossing saves: its (ug, vg) are
  // the row's (but under kGvAtSave).
  bool e;
  S ug_new, vg_new;
  F y7[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) y7[v] = F(y_new[v]);
  F t7 = F(0);  // the 7th stage's time (time instances only)
  if constexpr (kTime) t7 = F(t_new);
  if constexpr (kGvAtSave) {
    rwrt::ray_rhs<F, I>(bg, y7, t7, k[6], &e);
  } else {
    F ug7, vg7;
    rwrt::ray_rhs<F, I>(bg, y7, t7, k[6], &e, &ug7, &vg7);
    ug_new = S(ug7);
    vg_new = S(vg7);
  }
  S error_norm;
  if constexpr (kSpread) {
    own.k[6] = I::template own<F, 5>(k[6]);
    error_norm = rwrt::dp45::error_norm<S, F, I>(own, hs, a.atol, a.rtol);
  } else {
    error_norm = rwrt::dp45::error_norm(k, hs, L.y, y_new, a.atol, a.rtol);
  }
  if (isnan(error_norm)) error_norm = S(0);

  const bool accept = (error_norm < S(1)) || frozen;
  S fac_acc, fac_rej;
  rwrt::dp45::step_factors(error_norm, L.rej, &fac_acc, &fac_rej);
  S h_next = accept ? hs * fac_acc : hs * fac_rej;
  if (frozen) h_next = L.h;

  S t_out = accept ? t_new : L.t;
  if (isnan(t_out)) t_out = bound;
  if (accept) {
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      L.y[v] = y_new[v];
      L.f[v] = k[6][v];
    }
  }
  if (accept && t_out >= bound) {
    // Crossing: the kill test against the last saved position; a killed
    // row is NaN (state and (ug, vg)) and so is the carry.
    const bool killed =
        rwrt::kill_mask<S, KillI>(L.y, L.plon, L.plat, a.cut_off);
    if (killed) {
#pragma unroll
      for (int v = 0; v < 5; ++v) L.y[v] = nan;
      ug_new = vg_new = nan;
    }
    if constexpr (kGvAtSave) {
      if (!killed) {
        rwrt::group_velocity_at<S, F, I>(bg, L.y, t_new, &ug_new, &vg_new);
      }
    }
    store(L.idx, L.y, ug_new, vg_new);
    L.nb = L.idx + 1;
    L.plon = L.y[0];
    L.plat = L.y[1];
    // Dead after the crossing: skip the remaining bounds.
    L.idx = isnan(L.y[0]) ? G : L.idx + 1;
  }
  L.t = t_out;
  L.h = h_next;
  if (!frozen) {
    L.rej = !accept;
    L.ns = accept;
    ++L.att;
  }
  ++L.trips;
  return false;
}

// Lane L leaves: its carry, and the whole run's truncation count or the
// single group's controller flags, next bound and trips.
template <bool kRun, class I, typename S, typename F, bool kTime>
__device__ __forceinline__ void exact_finish(const ExactArgs<S, F, kTime>& a,
                                             const ExactLane<S, F>& L) {
  if (!I::lead()) return;
  const long long RL = a.R;
  const int i = L.i;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    a.y[v * RL + i] = L.y[v];
    a.f[v * RL + i] = L.f[v];
  }
  a.t[i] = L.t;
  a.h[i] = L.h;
  a.plon[i] = L.plon;
  a.plat[i] = L.plat;
  if constexpr (kRun) {
    a.trunc[i] = L.trunc;
  } else {
    a.rejected[i] = L.rej;
    a.new_step[i] = L.ns;
    a.idx[i] = L.idx;
    a.trips[i] = static_cast<int>(L.trips);
  }
}

// One thread (or team) a lane, each lane run to its end in launch order:
// the single group, and the float32 whole run.
template <typename S, typename F, bool kRun, bool kBarrier, bool kTime,
          class I>
__global__ void __launch_bounds__(rwrt::kBlock)
    exact_kernel(const ExactArgs<S, F, kTime> a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / I::kThreads;
  if (i >= a.R) return;
  const auto& bg = rwrt::lane_background(a.bg, i);
  ExactLane<S, F> L;
  exact_start<kRun, I>(a, i, L);
  while (!exact_iterate<kRun, kBarrier, I>(a, bg, L)) {
  }
  exact_finish<kRun, I>(a, L);
}

// The carries of a block's lanes between two windows, one slot a lane, in
// shared memory (structure of arrays). A lane's bounds and final time
// follow from g.
template <typename S, typename F, int N>
struct ExactSlots {
  S y[5][N];
  S t[N], h[N], plon[N], plat[N];
  long long trips[N];
  F f[5][N];
  int i[N], g[N], idx[N], nb[N], att[N], trunc[N], flags[N];
};

// The float64-state whole run's lane functions, as repack.cuh's run_lanes
// takes them.
template <typename S, typename F, bool kBarrier, bool kTime, class I>
struct ExactRun {
  const ExactArgs<S, F, kTime>& a;
  using Lane = ExactLane<S, F>;
  template <int N>
  using Slots = ExactSlots<S, F, N>;
  static constexpr bool kPost = false;

  __device__ __forceinline__ void start(int i, Lane& L) const {
    exact_start<true, I>(a, i, L);
  }
  __device__ __forceinline__ decltype(auto) background(const Lane& L) const {
    return rwrt::lane_background(a.bg, L.i);
  }
  template <typename BG>
  __device__ __forceinline__ bool step(const BG& bg, Lane& L) const {
    return exact_iterate<true, kBarrier, I>(a, bg, L);
  }
  __device__ __forceinline__ void finish(const Lane& L) const {
    exact_finish<true, I>(a, L);
  }
  template <int N>
  __device__ __forceinline__ void save(Slots<N>& s, int k,
                                       const Lane& L) const {
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      s.y[v][k] = L.y[v];
      s.f[v][k] = L.f[v];
    }
    s.t[k] = L.t;
    s.h[k] = L.h;
    s.plon[k] = L.plon;
    s.plat[k] = L.plat;
    s.trips[k] = L.trips;
    s.i[k] = L.i;
    s.g[k] = L.g;
    s.idx[k] = L.idx;
    s.nb[k] = L.nb;
    s.att[k] = L.att;
    s.trunc[k] = L.trunc;
    s.flags[k] = int(L.rej) | int(L.ns) << 1 | int(L.frozen_g) << 2;
  }
  template <int N>
  __device__ __forceinline__ void load(const Slots<N>& s, int k,
                                       Lane& L) const {
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      L.y[v] = s.y[v][k];
      L.f[v] = s.f[v][k];
    }
    L.t = s.t[k];
    L.h = s.h[k];
    L.plon = s.plon[k];
    L.plat = s.plat[k];
    L.trips = s.trips[k];
    L.i = s.i[k];
    L.g = s.g[k];
    L.idx = s.idx[k];
    L.nb = s.nb[k];
    L.att = s.att[k];
    L.trunc = s.trunc[k];
    const int fl = s.flags[k];
    L.rej = fl & 1;
    L.ns = fl & 2;
    L.frozen_g = fl & 4;
    const long long g = L.g < 0 ? 0 : L.g;
    L.bounds = a.bounds + g * a.G;
    L.t_end = L.g < 0 ? L.t : __ldg(L.bounds + a.G - 1);
  }
};

// The float64-state whole run on a persistent grid, live lanes (whole
// teams) repacked into full warps (see the head of this file).
template <typename S, typename F, bool kBarrier, bool kTime, class I>
__global__ void __launch_bounds__(kRunBlock, 1)
    exact_run_kernel(const ExactArgs<S, F, kTime> a) {
  rwrt::run_lanes<kRunBlock, I>(ExactRun<S, F, kBarrier, kTime, I>{a}, a.R,
                                a.queue, a.every, a.trigger);
}

template <typename S, typename F, bool kRun, bool kBarrier, bool kTime>
int launch_exact(const ExactArgs<S, F, kTime>& a, int inst,
                 cudaStream_t stream) {
  // A whole run with no group still writes row 0.
  if (a.R <= 0 || a.G <= 0 || (!kRun && a.n_groups <= 0)) return cudaSuccess;
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::launch_as<I>(exact_kernel<S, F, kRun, kBarrier, kTime, I>,
                              a, a.R, stream);
  });
}

// The float64-state whole run over `blocks` blocks of kRunBlock threads
// (at most R): the persistent grid of the blocks the card keeps resident
// (exact_grid), or fewer or more when a caller asks. The lane queue's
// counter must be zero.
template <typename S, typename F, bool kBarrier, bool kTime>
int launch_repacked(const ExactArgs<S, F, kTime>& a, int inst, int blocks,
                    cudaStream_t stream) {
  if (a.R <= 0 || a.G <= 0) return cudaSuccess;
  if (blocks <= 0 || a.every <= 0 || a.trigger <= 0 || a.queue == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int grid = blocks < a.R ? blocks : a.R;
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    exact_run_kernel<S, F, kBarrier, kTime, I>
        <<<grid, kRunBlock, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

// The whole run's grid on the current card for instance inst: out[0] the
// blocks the card keeps resident at once, out[1] the threads a block. A
// float64 state: the repacked kernel's persistent grid; float32: the
// launch-order kernel's blocks of rwrt::kBlock.
template <typename S, typename F, bool kTime>
int exact_grid(int inst, int* out) {
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    if constexpr (std::is_same<S, double>::value) {
      return rwrt::persistent_grid<kRunBlock>(
          exact_run_kernel<S, F, false, kTime, I>, out);
    } else {
      return rwrt::persistent_grid<rwrt::kBlock>(
          exact_kernel<S, F, true, false, kTime, I>, out);
    }
  });
}

// Resident threads of the whole run (run != 0: its grid's) or the single
// group.
template <typename S, typename F, bool kTime>
int exact_resident(int run, int inst, int* out) {
  if (run) {
    int grid[2] = {0, 0};
    const int e = exact_grid<S, F, kTime>(inst, grid);
    *out = grid[0] * grid[1];
    return e;
  }
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::resident_threads(
        exact_kernel<S, F, false, false, kTime, I>, out);
  });
}

template <typename S, typename F, bool kTime>
ExactArgs<S, F, kTime> exact_args(const rwrt::Background<F, kTime>& bg,
                                  void* y, void* t, void* h, void* f,
                                  void* plon, void* plat, void* lane_att,
                                  void* hist, const void* bounds, int G,
                                  int n_groups, int R, double cut_off,
                                  double rtol, double atol, double min_step,
                                  long long max_iters) {
  ExactArgs<S, F, kTime> a{};
  a.bg = bg;
  a.y = static_cast<S*>(y);
  a.t = static_cast<S*>(t);
  a.h = static_cast<S*>(h);
  a.f = static_cast<F*>(f);
  a.plon = static_cast<S*>(plon);
  a.plat = static_cast<S*>(plat);
  a.lane_att = static_cast<int*>(lane_att);
  a.hist = static_cast<S*>(hist);
  a.bounds = static_cast<const S*>(bounds);
  a.G = G;
  a.n_groups = n_groups;
  a.R = R;
  a.cut_off = S(cut_off);
  a.rtol = S(rtol);
  a.atol = S(atol);
  a.min_step = S(min_step);
  a.max_iters = max_iters;
  return a;
}

// The whole run over background bg (static or a time instance's): with a
// float64 state repacked on `blocks` blocks (lane queue `queue`, a repack
// at most every `every` loop iterations and once `trigger` lanes have
// left), in float32 in launch order (blocks, queue, every and trigger
// unused).
template <typename S, typename F, bool kTime>
int run_exact(const rwrt::Background<F, kTime>& bg, void* y, void* t,
              void* h, void* f, void* plon, void* plat, const void* ug0,
              const void* vg0, void* hist, void* ugs, void* vgs,
              void* lane_att, void* trunc, const void* bounds, int G,
              int n_groups, int R, double cut_off, double rtol, double atol,
              double min_step, long long max_iters, int barrier, int inst,
              int blocks, void* queue, int every, int trigger,
              void* stream) {
  ExactArgs<S, F, kTime> a = exact_args<S, F, kTime>(
      bg, y, t, h, f, plon, plat, lane_att, hist, bounds, G, n_groups, R,
      cut_off, rtol, atol, min_step, max_iters);
  a.ug0 = static_cast<const S*>(ug0);
  a.vg0 = static_cast<const S*>(vg0);
  a.ugs = static_cast<S*>(ugs);
  a.vgs = static_cast<S*>(vgs);
  a.trunc = static_cast<int*>(trunc);
  a.queue = static_cast<int*>(queue);
  a.every = every;
  a.trigger = trigger;
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<S, double>::value) {
    return barrier ? launch_repacked<S, F, true, kTime>(a, inst, blocks, s)
                   : launch_repacked<S, F, false, kTime>(a, inst, blocks, s);
  } else {
    return barrier ? launch_exact<S, F, true, true, kTime>(a, inst, s)
                   : launch_exact<S, F, true, false, kTime>(a, inst, s);
  }
}

// The single group over background bg (static or a time instance's).
template <typename S, typename F, bool kTime>
int group_exact(const rwrt::Background<F, kTime>& bg, void* y, void* t,
                void* h, void* f, void* plon, void* plat, void* rejected,
                void* new_step, void* lane_att, void* idx, void* trips,
                void* hist, const void* bounds, int G, int R, int resume,
                double cut_off, double rtol, double atol, double min_step,
                long long max_iters, int inst, void* stream) {
  ExactArgs<S, F, kTime> a = exact_args<S, F, kTime>(
      bg, y, t, h, f, plon, plat, lane_att, hist, bounds, G, 1, R, cut_off,
      rtol, atol, min_step, max_iters);
  a.rejected = static_cast<bool*>(rejected);
  a.new_step = static_cast<bool*>(new_step);
  a.idx = static_cast<int*>(idx);
  a.trips = static_cast<int*>(trips);
  a.resume = resume != 0;
  return launch_exact<S, F, false, false, kTime>(
      a, inst, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// The single group, state type S over background type F.
#define RWRT_EXACT_GROUP(SUFFIX, S, F)                                        \
  int rwrt_exact_group_##SUFFIX(                                              \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, void* y, void* t, void* h, void* f, void* plon, void* plat,  \
      void* rejected, void* new_step, void* lane_att, void* idx, void* trips, \
      void* hist, const void* bounds, int G, int R, int resume,               \
      double cut_off, double rtol, double atol, double min_step,              \
      long long max_iters, int inst, void* stream) {                          \
    return group_exact<S, F>(                                                 \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy), y, t, h,  \
        f, plon, plat, rejected, new_step, lane_att, idx, trips, hist,        \
        bounds, G, R, resume, cut_off, rtol, atol, min_step, max_iters, inst, \
        stream);                                                              \
  }

// Its time instance: the background's time axis and member map after the
// grid.
#define RWRT_EXACT_GROUP_TIME(SUFFIX, S, F)                                   \
  int rwrt_exact_group_time_##SUFFIX(                                         \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, int nt, int timed, double t0, double tdt,                    \
      const void* member, void* y, void* t, void* h, void* f, void* plon,     \
      void* plat, void* rejected, void* new_step, void* lane_att, void* idx,  \
      void* trips, void* hist, const void* bounds, int G, int R, int resume,  \
      double cut_off, double rtol, double atol, double min_step,              \
      long long max_iters, int inst, void* stream) {                          \
    return group_exact<S, F>(                                                 \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy, nt, timed, \
                                 t0, tdt, member),                            \
        y, t, h, f, plon, plat, rejected, new_step, lane_att, idx, trips,     \
        hist, bounds, G, R, resume, cut_off, rtol, atol, min_step, max_iters, \
        inst, stream);                                                        \
  }

// The whole run, state type S over background type F (a float64 state on
// `blocks` blocks with the lane queue's counter `queue`, a repack at most
// every `every` loop iterations and once `trigger` lanes have left), the
// resident counts of the whole run and the single group, and the whole
// run's grid.
#define RWRT_EXACT_RUN(SUFFIX, S, F)                                          \
  int rwrt_exact_run_##SUFFIX(                                                \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, void* y, void* t, void* h, void* f, void* plon, void* plat,  \
      const void* ug0, const void* vg0, void* hist, void* ugs, void* vgs,     \
      void* lane_att, void* trunc, const void* bounds, int G, int n_groups,   \
      int R, double cut_off, double rtol, double atol, double min_step,       \
      long long max_iters, int barrier, int inst, int blocks, void* queue,    \
      int every, int trigger, void* stream) {                                 \
    return run_exact<S, F>(                                                   \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy), y, t, h,  \
        f, plon, plat, ug0, vg0, hist, ugs, vgs, lane_att, trunc, bounds, G,  \
        n_groups, R, cut_off, rtol, atol, min_step, max_iters, barrier, inst, \
        blocks, queue, every, trigger, stream);                               \
  }                                                                           \
  int rwrt_exact_resident_##SUFFIX(int run, int inst, void* out) {            \
    return exact_resident<S, F, false>(run, inst, static_cast<int*>(out));    \
  }                                                                           \
  int rwrt_exact_grid_##SUFFIX(int inst, void* out) {                         \
    return exact_grid<S, F, false>(inst, static_cast<int*>(out));             \
  }

// Its time instance: the background's time axis and member map after the
// grid; its resident counts and grid.
#define RWRT_EXACT_RUN_TIME(SUFFIX, S, F)                                     \
  int rwrt_exact_run_time_##SUFFIX(                                           \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, int nt, int timed, double t0, double tdt,                    \
      const void* member, void* y, void* t, void* h, void* f, void* plon,     \
      void* plat, const void* ug0, const void* vg0, void* hist, void* ugs,    \
      void* vgs, void* lane_att, void* trunc, const void* bounds, int G,      \
      int n_groups, int R, double cut_off, double rtol, double atol,          \
      double min_step, long long max_iters, int barrier, int inst,            \
      int blocks, void* queue, int every, int trigger, void* stream) {        \
    return run_exact<S, F>(                                                   \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy, nt, timed, \
                                 t0, tdt, member),                            \
        y, t, h, f, plon, plat, ug0, vg0, hist, ugs, vgs, lane_att, trunc,    \
        bounds, G, n_groups, R, cut_off, rtol, atol, min_step, max_iters,     \
        barrier, inst, blocks, queue, every, trigger, stream);                \
  }                                                                           \
  int rwrt_exact_resident_time_##SUFFIX(int run, int inst, void* out) {       \
    return exact_resident<S, F, true>(run, inst, static_cast<int*>(out));     \
  }                                                                           \
  int rwrt_exact_grid_time_##SUFFIX(int inst, void* out) {                    \
    return exact_grid<S, F, true>(inst, static_cast<int*>(out));              \
  }

// One precision and one kind of background per translation unit, so that
// they compile in parallel (exact_run_f64.cu, exact_run_mix.cu and the time
// instances' exact_run_time.cu, exact_run_time_f64.cu and
// exact_run_time_mix.cu include this file).
#if defined(RWRT_EXACT_TIME_F64)
RWRT_EXACT_GROUP_TIME(f64, double, double)
RWRT_EXACT_RUN_TIME(f64, double, double)
#elif defined(RWRT_EXACT_TIME_MIX)
RWRT_EXACT_GROUP_TIME(mix, double, float)
RWRT_EXACT_RUN_TIME(mix, double, float)
#elif defined(RWRT_EXACT_TIME)
RWRT_EXACT_GROUP_TIME(f32, float, float)
RWRT_EXACT_RUN_TIME(f32, float, float)
#elif defined(RWRT_EXACT_F64)
RWRT_EXACT_GROUP(f64, double, double)
RWRT_EXACT_RUN(f64, double, double)
#elif defined(RWRT_EXACT_MIX)
RWRT_EXACT_GROUP(mix, double, float)
RWRT_EXACT_RUN(mix, double, float)
#else
RWRT_EXACT_GROUP(f32, float, float)
RWRT_EXACT_RUN(f32, float, float)
#endif

#undef RWRT_EXACT_GROUP
#undef RWRT_EXACT_GROUP_TIME
#undef RWRT_EXACT_RUN
#undef RWRT_EXACT_RUN_TIME

}  // extern "C"
