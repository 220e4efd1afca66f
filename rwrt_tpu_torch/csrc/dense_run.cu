// Dense Dormand-Prince kernels: free-stepping DP 5(4) with dense output,
// from one set of lane functions (lane_start, lane_iterate, lane_finish).
//
//   dense_kernel<S, F, false, kTime>
//                           one group of output bounds in one launch, one
//                           thread per lane (rwrt_dense_group:
//                           solvers/rk45.py integrate_group_dense on CUDA);
//   dense_kernel<S, F, true, kTime>
//                           the whole adaptive run in one launch
//                           (rwrt_dense_run: tracer._dense_run on CUDA),
//                           live lanes repacked into full warps inside it.
//                           Each lane walks every group of bounds, applies
//                           the kill cascade at each bound in bound order,
//                           writes its rows straight into the run's
//                           (nt, 5, R) output, and has (ug, vg) sampled
//                           there once it is done.
//
// Replaces (rwrt_tpu, fused by XLA there, no Pallas original):
//   tracer.py:861-936 _run_rk45_grouped, dense branch (the group loop, the
//   entry freeze, the truncation count); tracer.py:275-313 _dense_postpass
//   (kill cascade, group velocity at every bound, the carry's NaN);
//   solvers/rk45.py:494 integrate_group_dense (the while_loop body: FSAL
//   stages, error norm, accept/reject with the NaN-reject rule, the h
//   update, quartic DP_P emission, both pin-kill arms) with its entry state
//   dense_entry_state (frozen lanes prefilled, t -> t_end).
// Plain PyTorch versions: rwrt_tpu_torch/tracer.py _dense_run_plain and
// rwrt_tpu_torch/solvers/rk45.py _integrate_group_dense_plain, whose
// expressions and order this follows.
//
// What bounds the whole run on an H100. Bytes: the output, (nt, 5, R) rows
// plus (nt, R) ug and vg, 0.61 GB in float32 at the production shape
// (R = 60,784 lanes, nt = 361: 439 MB + 175 MB), 0.18 ms at 3.35 TB/s; the
// inputs are a few MB. Operations, counted from the sources: a step attempt
// is six RHS evaluations of ~182 flops plus ~342 for the stage sums, error
// norm and controller; a kept row ~126 for the quartic interpolant and
// ~156 for the kill test and the (ug, vg) sample. The production run's
// 6.89 M attempts and 21.6 M rows make ~16 GFLOP, 0.24 ms at the 67 TFLOP/s
// float32 peak. Neither is near; three other limits are:
//   - The chain floor. A lane is a serial chain of trips, each six
//     dependent RHS evaluations (a dependent 48-value gather from the
//     L2-resident background, IEEE division, sqrt, sin and cos) and a pow,
//     so the launch lasts at least the longest lane's trips over all groups
//     (910 in the production run) times a lone lane's trip (~6.6 us on an
//     H100, profile_main_path.py): ~6 ms.
//   - Warp occupancy. A warp issues every instruction for its 32 threads
//     until its slowest lane leaves the loop, so the issue slots a launch
//     spends are counted in warp-trips: each warp's slowest lane's trips.
//     Lanes come in the order of the rootless-lane compaction (source and
//     wavenumber), not of difficulty: on the production seeding the mean
//     lane makes ~113 trips and the longest 910, and with one thread a lane
//     in launch order 24 % of the issued lane-slots carry a live lane
//     (profile_main_path.warp_occupancy). Where a trip's arithmetic is what
//     the SMs run out of (float64 and mixed precision: the FP64 pipes), the
//     idle slots are the launch's time.
//   - The rows' stores. Each row writes five 4- or 8-byte values, each into
//     a sector of the (nt, 5, R) output that seven other lanes fill at
//     other times, so the sectors reach memory partly written; and the
//     post-pass reads them back the same way. In float32 this, not the
//     issue slots, holds the launch above its chain floor: the production
//     lanes sorted by their trips (warp occupancy 0.998) run no faster than
//     in launch order, while its 1 % of lanes with the most trips alone run
//     within 10 % of the chain floor.
//
// Design: the batch-wide XLA loop becomes a per-lane loop, so no launch is
// spent per trip or per group. Pin-kill retires a lane that reaches
// pin_limit attempts in a group, so no lane is the straggler of two
// groups: one launch pays the longest lane's total (910 trips) instead of
// the sum of each group's longest lane (2,642). One loop runs the trips
// and the group changes (lane_iterate), so the lanes of a warp that are
// stepping run each trip together, whichever group each is in.
//
// The whole run repacks live lanes into full warps inside the launch
// (repack.cuh run_lanes, shared with the exact kernel's float64-state
// runs): a persistent grid of the blocks the card keeps resident
// (dense_resident), each as wide as one SM's registers allow (RunBlock:
// 512 threads in float32, 384 in its time instance, 256 with a float64
// state), deals each block an even share of the lanes and queues the rest;
// each block alternates windows of up to `every` iterations of each live
// lane (ended early once `trigger` lanes have left it) with a repack of
// its live lanes into its lowest threads, a refill from the queue and the
// (ug, vg) post-pass of the lanes that left in the window, one (lane, row)
// a thread over the whole block, group_velocity_at at each row's bound
// (the expression of the plain post-pass). The wrapper picks `every` and
// `trigger` by precision (tracer.py DENSE_SCHEDULE): a repack's barriers
// hold every warp of the block to its slowest, which float32 pays for more
// than it gains from full warps, so it repacks rarely; float64 repacks as
// each lane leaves. A lane's arithmetic is the one-thread-a-lane loop's in
// its order; only the thread that runs it changes between windows, and
// where its carry sits meanwhile. Rows, (ug, vg), lane_att, trunc and the
// carry are addressed by the lane's
// index. The single group (integrate_group_dense) keeps one thread a lane
// in blocks of 128, from the same lane functions.
//
// The stages stay in registers; emission walks a pointer over the
// (non-decreasing) bounds. The kill cascade runs at emission, in bound
// order, on the lane's own last alive position; the bounds a lane never
// reached are cascaded as death at the group's end, exactly as the plain
// post-pass reads the NaN-prefilled history. A killed lane keeps
// integrating to the group's end, so attempts and the truncation count
// equal the plain version's; its carry is NaNed after the group. Work stays
// out of the emission branch, which is divergent (each lane emits its own
// bounds, about three per trip): the haversine runs only where a cheap
// bound cannot rule the kill out (ray_rhs.cuh kill_mask), and the
// background row comes in 16-byte loads.
//
// The Dormand-Prince stages, error norm and step factors are dp45.cuh's,
// shared with the exact kernels (exact_run.cu).
//
// Types: the state S (y, t, h, the controller, the emitted rows, the kill
// cascade, (ug, vg)) and the background F (the RHS, the stages k, the FSAL
// carry f): dense_kernel<T, T, kRun, kTime> is the one-type kernel;
// dense_kernel<double, float, true, kTime> the mixed-precision whole run and
// dense_kernel<double, float, false, kTime> its single group (the _mix entry
// points, compiled in dense_run_mix.cu). The Dormand-Prince casts are
// dp45.cuh's; the dense
// interpolant runs in S, its weights b_i(theta) times the widened stages,
// summed in S, as the JAX package's promotion has it; the post-pass's
// (ug, vg) are group_velocity_at<S, F> at the S rows.
//
// Time: a trial's stages sample at t + c_s h (dp45.cuh trial), its 7th
// stage at t + h, and a row's (ug, vg) at its bound's time, as the plain
// versions pass them. Only the time instances (kTime: dense_run_time*.cu,
// the whole run and the single group over a time-varying or ensemble
// background, ray_rhs.cuh) read the time; the static instances' code is
// the code without it.
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

#include "dp45.cuh"
#include "repack.cuh"

namespace {

using rwrt::dp45::nan_max;
using rwrt::dp45::nan_min;

template <typename S, typename F, bool kTime>
struct DenseArgs {
  rwrt::Background<F, kTime> bg;
  // Carry, (5, R) / (R,): read at entry, written at exit. The whole run
  // enters with t = 0.
  S* y;
  S* t;
  S* h;
  F* f;
  bool* rejected;  // single group: the controller flags at exit
  bool* new_step;
  int* lane_att;   // (n_groups, R): step attempts per group
  // Single group: (G, 5, R). Whole run: (n_groups * G + 1, 5, R), row 0
  // the entry state, row 1 + g * G + b bound b of group g.
  S* hist;
  const S* bounds;  // (n_groups, G), non-decreasing within a group
  int G;
  int n_groups;
  int R;
  S rtol, atol, min_step;
  long long max_iters, pin_limit;
  S pin_mwn;
  // Whole run only: row 0 of (ug, vg); the (n_groups * G + 1, R) (ug, vg)
  // rows; the truncation count per lane; the cascade's last alive position
  // at exit; the haversine kill threshold; the lane queue's counter (one
  // int, zero at launch); the most loop iterations between two repacks,
  // and the lanes that, once they have left the block, end a window
  // early.
  const S* ug0;
  const S* vg0;
  S* ugs;
  S* vgs;
  int* trunc;
  S* plon;
  S* plat;
  S cut_off;
  int* queue;
  int every;
  int trigger;
};

// Threads per block of the whole run: the widest block whose registers fit
// one SM (65,536), so that a block repacks its lanes over as many warps as
// one SM holds, with few or no spills (nvcc.log). The single group keeps
// blocks of 128.
template <typename S, bool kTime>
struct RunBlock {
  // float32: at most 128 registers; its time instance, which carries the
  // time axis and the second frame's row, at most 168.
  static constexpr int kThreads = kTime ? 384 : 512;
};
template <bool kTime>
struct RunBlock<double, kTime> {
  static constexpr int kThreads = 256;  // float64 and mixed: at most 255
};

template <typename S, bool kRun, bool kTime>
struct Block {
  static constexpr int kThreads = kRun ? RunBlock<S, kTime>::kThreads : 128;
};

// One lane's carry between loop iterations: the state and FSAL stage, the
// controller, the current group g (-1 before the first) with its bounds,
// final time, first output row, entry freeze, next bound to emit and
// attempts; the kill cascade's last alive emitted position and whether
// the lane is alive in g; its truncation count.
template <typename S, typename F>
struct DenseLane {
  S y[5];
  F f[5];
  S t, h, t_end, plon, plat;
  const S* bounds;
  long long row0;
  int i, g, nb, att, trunc;
  bool rej, ns, frozen, alive;
};

// Lane i enters from the carry (and, in the whole run, writes its row 0).
template <bool kRun, typename S, typename F, bool kTime>
__device__ __forceinline__ void lane_start(const DenseArgs<S, F, kTime>& a,
                                           int i, DenseLane<S, F>& L) {
  const long long RL = a.R;
  L.i = i;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    L.y[v] = a.y[v * RL + i];
    L.f[v] = a.f[v * RL + i];
  }
  L.t = a.t[i];
  L.h = a.h[i];
  L.rej = false;
  L.ns = true;
  L.plon = L.y[0];
  L.plat = L.y[1];
  L.alive = true;
  L.trunc = 0;
  if constexpr (kRun) {
#pragma unroll
    for (int v = 0; v < 5; ++v) a.hist[v * RL + i] = L.y[v];
    a.ugs[i] = a.ug0[i];
    a.vgs[i] = a.vg0[i];
  }
  L.g = -1;
  L.bounds = a.bounds;
  L.t_end = L.t;  // no trip before the first group opens
  L.row0 = 0;
  L.frozen = false;
  L.nb = 0;
  L.att = 0;
}

// One iteration of lane L's loop: a trip of its group, or the change from
// one group to the next. Returns true when the lane has closed its last
// group. The lanes of a warp that are stepping run each trip together,
// whichever group each is in (a loop per group would hold them at each
// group's end).
template <bool kRun, typename S, typename F, bool kTime, typename BG>
__device__ __forceinline__ bool lane_iterate(const DenseArgs<S, F, kTime>& a,
                                             const BG& bg,
                                             DenseLane<S, F>& L) {
  // The dense-output quartic (solvers/rk45.py DP_P), double literals
  // rounded to S where used. A local constexpr array, so the unrolled loops
  // index it at compile time.
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

  const long long RL = a.R;
  const int G = a.G;
  const int i = L.i;
  const S nan = rwrt::nan_value<S>();
  auto store = [&](int b, const S row[5]) {
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      a.hist[((L.row0 + b) * 5 + v) * RL + i] = row[v];
    }
  };
  // A NaN row: an unreached bound, or one the cascade killed.
  auto store_dead = [&](int b) {
    const S row[5] = {nan, nan, nan, nan, nan};
    store(b, row);
    if constexpr (kRun) L.alive = false;
  };

  if (!(L.t < L.t_end) || static_cast<long long>(L.att) >= a.max_iters) {
    if (L.g >= 0) {
      // Close group g. Bounds the lane never reached stay NaN: death, in
      // bound order.
      if (!L.frozen) {
        for (int b = L.nb; b < G; ++b) store_dead(b);
      }
      if constexpr (kRun) {
        // Counted at integration end, before the carry's NaN: a lane the
        // backstop stopped short while alive.
        if (L.t < L.t_end && !isnan(L.y[0])) ++L.trunc;
        if (!L.alive && !L.frozen) {
#pragma unroll
          for (int v = 0; v < 5; ++v) L.y[v] = nan;
        }
      }
      a.lane_att[L.g * RL + i] = L.att;
    }
    if (++L.g == a.n_groups) return true;
    // Open group g.
    L.bounds = a.bounds + static_cast<long long>(L.g) * G;
    L.t_end = __ldg(L.bounds + G - 1);
    L.row0 = kRun ? 1 + static_cast<long long>(L.g) * G : 0;
    // Entry state: any NaN component (isnan(mean(y))) freezes the lane at
    // its entry state for every bound, outside the cascade.
    L.frozen =
        isnan((L.y[0] + L.y[1] + L.y[2] + L.y[3] + L.y[4]) / S(5));
    L.alive = !L.frozen;
    if (L.frozen) {
      for (int b = 0; b < G; ++b) store(b, L.y);
      L.t = L.t_end;
    }
    L.rej = false;
    L.ns = true;
    L.att = 0;
    // First bound strictly after t (bounds are non-decreasing); a live
    // lane never emits the bounds before it.
    L.nb = 0;
    while (L.nb < G && !(__ldg(L.bounds + L.nb) > L.t)) ++L.nb;
    if (!L.frozen) {
      for (int b = 0; b < L.nb; ++b) store_dead(b);
    }
    return false;
  }

  // One trip of group g.
  const S heff = L.ns ? nan_max(L.h, a.min_step) : L.h;
  const S t_new = nan_min(L.t + heff, L.t_end);
  const S hs = t_new - L.t;

  F k[7][5];
#pragma unroll
  for (int v = 0; v < 5; ++v) k[0][v] = L.f[v];
  S y_new[5];
  rwrt::dp45::trial(bg, L.y, L.t, hs, k, y_new);
  bool e;
  F y7[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) y7[v] = F(y_new[v]);
  F t7 = F(0);  // the 7th stage's time (time instances only)
  if constexpr (kTime) t7 = F(t_new);
  rwrt::ray_rhs(bg, y7, t7, k[6], &e);
  const S error_norm =
      rwrt::dp45::error_norm(k, hs, L.y, y_new, a.atol, a.rtol);

  const bool nan_err = isnan(error_norm);
  const bool dead_now = isnan(L.y[0]);
  const bool at_floor = hs <= a.min_step;
  const bool accept = nan_err ? (dead_now || at_floor) : (error_norm < S(1));
  S fac_acc, fac_rej;
  rwrt::dp45::step_factors(error_norm, L.rej, &fac_acc, &fac_rej);
  if (nan_err) fac_acc = S(1);
  if (nan_err) fac_rej = S(rwrt::dp45::kMinFactor);
  const S h_next = accept ? hs * fac_acc : hs * fac_rej;

  if (accept) {
    // Dense emission: every bound in (t, t_new] from the quartic
    // interpolant of this step's stages.
    const S hden = (hs == S(0)) ? S(1) : hs;
    while (L.nb < G) {
      const S bnd = __ldg(L.bounds + L.nb);
      if (!(bnd <= t_new)) break;
      const S th = (bnd - L.t) / hden;
      S bp[7];
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        bp[q] = th * (S(kP[q][0]) +
                      th * (S(kP[q][1]) +
                            th * (S(kP[q][2]) + th * S(kP[q][3]))));
      }
      S row[5];
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        S acc = bp[0] * S(k[0][v]);
#pragma unroll
        for (int q = 1; q < 7; ++q) acc = acc + bp[q] * S(k[q][v]);
        row[v] = L.y[v] + hs * acc;
      }
      if constexpr (kRun) {
        // Kill cascade at this bound.
        if (!L.alive || isnan(row[0]) ||
            rwrt::kill_mask(row, L.plon, L.plat, a.cut_off)) {
          store_dead(L.nb);
        } else {
          store(L.nb, row);
          L.plon = row[0];
          L.plat = row[1];
        }
      } else {
        store(L.nb, row);
      }
      ++L.nb;
    }
  }

  S y_out[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) y_out[v] = accept ? y_new[v] : L.y[v];
  S t_out = accept ? t_new : L.t;

  // Straggler pin-kill: accepted steps and rejections at the step floor.
  L.att += 1;
  const bool floor_rej = !accept && (hs <= a.min_step * S(1.0 + 1e-6));
  // The pin row is ky (state row 3), as in the plain version.
  const bool retire = (accept || floor_rej) &&
                      (static_cast<long long>(L.att) >= a.pin_limit) &&
                      (fabs(y_out[3]) >= a.pin_mwn);
  if (retire) {
#pragma unroll
    for (int v = 0; v < 5; ++v) y_out[v] = nan;
  }
  // Lanes whose state went NaN finish at once.
  if (isnan(y_out[0])) t_out = L.t_end;

  if (accept) {
#pragma unroll
    for (int v = 0; v < 5; ++v) L.f[v] = k[6][v];
  }
#pragma unroll
  for (int v = 0; v < 5; ++v) L.y[v] = y_out[v];
  L.t = t_out;
  L.h = h_next;
  L.rej = !accept;
  L.ns = accept;
  return false;
}

// Lane L leaves: its carry, and the whole run's truncation count and last
// alive position or the single group's controller flags.
template <bool kRun, typename S, typename F, bool kTime>
__device__ __forceinline__ void lane_finish(const DenseArgs<S, F, kTime>& a,
                                            const DenseLane<S, F>& L) {
  const long long RL = a.R;
  const int i = L.i;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    a.y[v * RL + i] = L.y[v];
    a.f[v * RL + i] = L.f[v];
  }
  a.t[i] = L.t;
  a.h[i] = L.h;
  if constexpr (kRun) {
    a.trunc[i] = L.trunc;
    a.plon[i] = L.plon;
    a.plat[i] = L.plat;
  } else {
    a.rejected[i] = L.rej;
    a.new_step[i] = L.ns;
  }
}

// (ug, vg) of lane i's output row r (r >= 1), at the row's bound.
template <typename S, typename F, bool kTime>
__device__ __forceinline__ void sample_row(const DenseArgs<S, F, kTime>& a,
                                           int i, long long r) {
  const long long RL = a.R;
  const auto& bg = rwrt::lane_background(a.bg, i);
  S row[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) row[v] = a.hist[(r * 5 + v) * RL + i];
  S tb = S(0);  // the row's bound
  if constexpr (kTime) tb = a.bounds[r - 1];
  S ug, vg;
  rwrt::group_velocity_at(bg, row, tb, &ug, &vg);
  a.ugs[r * RL + i] = ug;
  a.vgs[r * RL + i] = vg;
}

// The carries of a block's lanes between two windows, one slot a lane, in
// shared memory (structure of arrays: neighbouring slots, neighbouring
// banks). A lane's bounds, final time and first row follow from g.
template <typename S, typename F, int N>
struct DenseSlots {
  S y[5][N];
  S t[N], h[N], plon[N], plat[N];
  F f[5][N];
  int i[N], g[N], nb[N], att[N], trunc[N], flags[N];
};

// The whole run's lane functions, as repack.cuh's run_lanes takes them.
template <typename S, typename F, bool kTime>
struct DenseRun {
  const DenseArgs<S, F, kTime>& a;
  using Lane = DenseLane<S, F>;
  template <int N>
  using Slots = DenseSlots<S, F, N>;
  static constexpr bool kPost = true;

  __device__ __forceinline__ void start(int i, Lane& L) const {
    lane_start<true>(a, i, L);
  }
  __device__ __forceinline__ decltype(auto) background(const Lane& L) const {
    return rwrt::lane_background(a.bg, L.i);
  }
  template <typename BG>
  __device__ __forceinline__ bool step(const BG& bg, Lane& L) const {
    return lane_iterate<true>(a, bg, L);
  }
  __device__ __forceinline__ void finish(const Lane& L) const {
    lane_finish<true>(a, L);
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
    s.i[k] = L.i;
    s.g[k] = L.g;
    s.nb[k] = L.nb;
    s.att[k] = L.att;
    s.trunc[k] = L.trunc;
    s.flags[k] = int(L.rej) | int(L.ns) << 1 | int(L.frozen) << 2 |
                 int(L.alive) << 3;
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
    L.i = s.i[k];
    L.g = s.g[k];
    L.nb = s.nb[k];
    L.att = s.att[k];
    L.trunc = s.trunc[k];
    const int fl = s.flags[k];
    L.rej = fl & 1;
    L.ns = fl & 2;
    L.frozen = fl & 4;
    L.alive = fl & 8;
    const long long g = L.g < 0 ? 0 : L.g;
    L.bounds = a.bounds + g * a.G;
    L.t_end = L.g < 0 ? L.t : __ldg(L.bounds + a.G - 1);
    L.row0 = 1 + g * a.G;
  }
  // The (ug, vg) of every row of the nd lanes that left, one (lane, row) a
  // thread over the block's B threads.
  template <int B>
  __device__ __forceinline__ void post(const int* done, int nd,
                                       int tid) const {
    const long long rows = static_cast<long long>(a.n_groups) * a.G;
    const long long items = nd * rows;
    for (long long w = tid; w < items; w += B) {
      sample_row(a, done[static_cast<int>(w % nd)], 1 + w / nd);
    }
  }
};

// The single group: one thread per lane, from entry to exit.
template <typename S, typename F, bool kTime>
__device__ __forceinline__ void group_lane(const DenseArgs<S, F, kTime>& a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.R) return;
  const auto& bg = rwrt::lane_background(a.bg, i);
  DenseLane<S, F> L;
  lane_start<false>(a, i, L);
  while (!lane_iterate<false>(a, bg, L)) {
  }
  lane_finish<false>(a, L);
}

template <typename S, typename F, bool kRun, bool kTime>
__global__ void __launch_bounds__(Block<S, kRun, kTime>::kThreads, 1)
dense_kernel(const DenseArgs<S, F, kTime> a) {
  if constexpr (kRun) {
    rwrt::run_lanes<RunBlock<S, kTime>::kThreads, rwrt::Lane>(
        DenseRun<S, F, kTime>{a}, a.R, a.queue, a.every, a.trigger);
  } else {
    group_lane(a);
  }
}

// The whole run over `blocks` blocks (at most R): the persistent grid of
// the blocks the card keeps resident (dense_resident), or fewer or more
// when a caller asks. The lane queue's counter must be zero.
template <typename S, typename F, bool kTime>
int launch_run(const DenseArgs<S, F, kTime>& a, int blocks,
               cudaStream_t stream) {
  if (a.R <= 0 || a.G <= 0 || a.n_groups <= 0) return cudaSuccess;
  if (blocks <= 0 || a.every <= 0 || a.trigger <= 0 || a.queue == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int grid = blocks < a.R ? blocks : a.R;
  dense_kernel<S, F, true, kTime>
      <<<grid, RunBlock<S, kTime>::kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, typename F, bool kTime>
int launch_group(const DenseArgs<S, F, kTime>& a, cudaStream_t stream) {
  if (a.R <= 0 || a.G <= 0 || a.n_groups <= 0) return cudaSuccess;
  const int block = Block<S, false, kTime>::kThreads;
  const int grid = (a.R + block - 1) / block;
  dense_kernel<S, F, false, kTime><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

// The whole run's persistent grid on the current card: out[0] the blocks
// it keeps resident at once (blocks per SM x SMs), out[1] the threads a
// block.
template <typename S, typename F, bool kTime>
int dense_resident(int* out) {
  return rwrt::persistent_grid<RunBlock<S, kTime>::kThreads>(
      dense_kernel<S, F, true, kTime>, out);
}

template <typename S, typename F, bool kTime>
DenseArgs<S, F, kTime> dense_args(const rwrt::Background<F, kTime>& bg,
                                  void* y, void* t, void* h, void* f,
                                  void* lane_att, void* hist,
                                  const void* bounds, int G, int n_groups,
                                  int R, double rtol, double atol,
                                  double min_step, long long max_iters,
                                  long long pin_limit, double pin_mwn) {
  DenseArgs<S, F, kTime> a{};
  a.bg = bg;
  a.y = static_cast<S*>(y);
  a.t = static_cast<S*>(t);
  a.h = static_cast<S*>(h);
  a.f = static_cast<F*>(f);
  a.lane_att = static_cast<int*>(lane_att);
  a.hist = static_cast<S*>(hist);
  a.bounds = static_cast<const S*>(bounds);
  a.G = G;
  a.n_groups = n_groups;
  a.R = R;
  a.rtol = S(rtol);
  a.atol = S(atol);
  a.min_step = S(min_step);
  a.max_iters = max_iters;
  a.pin_limit = pin_limit;
  a.pin_mwn = S(pin_mwn);
  return a;
}

// The whole run over background bg (static or a time instance's).
template <typename S, typename F, bool kTime>
int run_dense(const rwrt::Background<F, kTime>& bg, void* y, void* t,
              void* h, void* f, const void* ug0, const void* vg0, void* hist,
              void* ugs, void* vgs, void* lane_att, void* trunc, void* plon,
              void* plat, const void* bounds, int G, int n_groups, int R,
              double cut_off, double rtol, double atol, double min_step,
              long long max_iters, long long pin_limit, double pin_mwn,
              int blocks, void* queue, int every, int trigger,
              void* stream) {
  DenseArgs<S, F, kTime> a = dense_args<S, F, kTime>(
      bg, y, t, h, f, lane_att, hist, bounds, G, n_groups, R, rtol, atol,
      min_step, max_iters, pin_limit, pin_mwn);
  a.ug0 = static_cast<const S*>(ug0);
  a.vg0 = static_cast<const S*>(vg0);
  a.ugs = static_cast<S*>(ugs);
  a.vgs = static_cast<S*>(vgs);
  a.trunc = static_cast<int*>(trunc);
  a.plon = static_cast<S*>(plon);
  a.plat = static_cast<S*>(plat);
  a.cut_off = S(cut_off);
  a.queue = static_cast<int*>(queue);
  a.every = every;
  a.trigger = trigger;
  return launch_run<S, F, kTime>(a, blocks,
                                 static_cast<cudaStream_t>(stream));
}

// The single group over background bg (static or a time instance's).
template <typename S, typename F, bool kTime>
int group_dense(const rwrt::Background<F, kTime>& bg, void* y, void* t,
                void* h, void* f, void* rejected, void* new_step,
                void* lane_att, void* hist, const void* bounds, int G, int R,
                double rtol, double atol, double min_step,
                long long max_iters, long long pin_limit, double pin_mwn,
                void* stream) {
  DenseArgs<S, F, kTime> a = dense_args<S, F, kTime>(
      bg, y, t, h, f, lane_att, hist, bounds, G, 1, R, rtol, atol, min_step,
      max_iters, pin_limit, pin_mwn);
  a.rejected = static_cast<bool*>(rejected);
  a.new_step = static_cast<bool*>(new_step);
  return launch_group<S, F, kTime>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// The single group, state type S over background type F.
#define RWRT_DENSE_GROUP(SUFFIX, S, F)                                       \
  int rwrt_dense_group_##SUFFIX(                                             \
      const void* packed, int W, int H, double lon0, double lat0, double dx, \
      double dy, void* y, void* t, void* h, void* f, void* rejected,         \
      void* new_step, void* lane_att, void* hist, const void* bounds, int G, \
      int R, double rtol, double atol, double min_step, long long max_iters, \
      long long pin_limit, double pin_mwn, void* stream) {                   \
    return group_dense<S, F>(                                                \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy), y, t, h, \
        f, rejected, new_step, lane_att, hist, bounds, G, R, rtol, atol,     \
        min_step, max_iters, pin_limit, pin_mwn, stream);                    \
  }

// Its time instance: the background's time axis and member map after the
// grid.
#define RWRT_DENSE_GROUP_TIME(SUFFIX, S, F)                                  \
  int rwrt_dense_group_time_##SUFFIX(                                        \
      const void* packed, int W, int H, double lon0, double lat0, double dx, \
      double dy, int nt, int timed, double t0, double tdt,                   \
      const void* member, void* y, void* t, void* h, void* f,                \
      void* rejected, void* new_step, void* lane_att, void* hist,            \
      const void* bounds, int G, int R, double rtol, double atol,            \
      double min_step, long long max_iters, long long pin_limit,             \
      double pin_mwn, void* stream) {                                        \
    return group_dense<S, F>(                                                \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy, nt,       \
                                 timed, t0, tdt, member),                    \
        y, t, h, f, rejected, new_step, lane_att, hist, bounds, G, R, rtol,  \
        atol, min_step, max_iters, pin_limit, pin_mwn, stream);              \
  }

// The whole run, state type S over background type F (on `blocks` blocks,
// with the lane queue's counter `queue`, a repack at most every `every`
// loop iterations and once `trigger` lanes have left), and its persistent
// grid.
#define RWRT_DENSE_RUN(SUFFIX, S, F)                                         \
  int rwrt_dense_run_##SUFFIX(                                               \
      const void* packed, int W, int H, double lon0, double lat0, double dx, \
      double dy, void* y, void* t, void* h, void* f, const void* ug0,        \
      const void* vg0, void* hist, void* ugs, void* vgs, void* lane_att,     \
      void* trunc, void* plon, void* plat, const void* bounds, int G,        \
      int n_groups, int R, double cut_off, double rtol, double atol,         \
      double min_step, long long max_iters, long long pin_limit,             \
      double pin_mwn, int blocks, void* queue, int every, int trigger,       \
      void* stream) {                                                        \
    return run_dense<S, F>(                                                  \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy), y, t, h, \
        f, ug0, vg0, hist, ugs, vgs, lane_att, trunc, plon, plat, bounds, G, \
        n_groups, R, cut_off, rtol, atol, min_step, max_iters, pin_limit,    \
        pin_mwn, blocks, queue, every, trigger, stream);                     \
  }                                                                          \
  int rwrt_dense_resident_##SUFFIX(void* out) {                              \
    return dense_resident<S, F, false>(static_cast<int*>(out));              \
  }

// Its time instance: the background's time axis and member map after the
// grid; its persistent grid.
#define RWRT_DENSE_RUN_TIME(SUFFIX, S, F)                                    \
  int rwrt_dense_run_time_##SUFFIX(                                          \
      const void* packed, int W, int H, double lon0, double lat0, double dx, \
      double dy, int nt, int timed, double t0, double tdt,                   \
      const void* member, void* y, void* t, void* h, void* f,                \
      const void* ug0, const void* vg0, void* hist, void* ugs, void* vgs,    \
      void* lane_att, void* trunc, void* plon, void* plat,                   \
      const void* bounds, int G, int n_groups, int R, double cut_off,        \
      double rtol, double atol, double min_step, long long max_iters,        \
      long long pin_limit, double pin_mwn, int blocks, void* queue,          \
      int every, int trigger, void* stream) {                                \
    return run_dense<S, F>(                                                  \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy, nt,       \
                                 timed, t0, tdt, member),                    \
        y, t, h, f, ug0, vg0, hist, ugs, vgs, lane_att, trunc, plon, plat,   \
        bounds, G, n_groups, R, cut_off, rtol, atol, min_step, max_iters,    \
        pin_limit, pin_mwn, blocks, queue, every, trigger, stream);          \
  }                                                                          \
  int rwrt_dense_resident_time_##SUFFIX(void* out) {                         \
    return dense_resident<S, F, true>(static_cast<int*>(out));               \
  }

// One precision and one kind of background per translation unit, so that
// they compile in parallel (dense_run_f64.cu, dense_run_mix.cu and the
// time instances' dense_run_time.cu, dense_run_time_f64.cu and
// dense_run_time_mix.cu include this file).
#if defined(RWRT_DENSE_TIME_F64)
RWRT_DENSE_GROUP_TIME(f64, double, double)
RWRT_DENSE_RUN_TIME(f64, double, double)
#elif defined(RWRT_DENSE_TIME_MIX)
RWRT_DENSE_GROUP_TIME(mix, double, float)
RWRT_DENSE_RUN_TIME(mix, double, float)
#elif defined(RWRT_DENSE_TIME)
RWRT_DENSE_GROUP_TIME(f32, float, float)
RWRT_DENSE_RUN_TIME(f32, float, float)
#elif defined(RWRT_DENSE_F64)
RWRT_DENSE_GROUP(f64, double, double)
RWRT_DENSE_RUN(f64, double, double)
#elif defined(RWRT_DENSE_MIX)
RWRT_DENSE_GROUP(mix, double, float)
RWRT_DENSE_RUN(mix, double, float)
#else
RWRT_DENSE_GROUP(f32, float, float)
RWRT_DENSE_RUN(f32, float, float)
#endif

#undef RWRT_DENSE_GROUP
#undef RWRT_DENSE_GROUP_TIME
#undef RWRT_DENSE_RUN
#undef RWRT_DENSE_RUN_TIME

}  // extern "C"
