// Dense Dormand-Prince kernels: free-stepping DP 5(4) with dense output,
// one thread per lane, from one templated body.
//
//   dense_kernel<S, F, false, kTime>
//                           one group of output bounds in one launch
//                           (rwrt_dense_group: solvers/rk45.py
//                           integrate_group_dense on CUDA);
//   dense_kernel<S, F, true, kTime>
//                           the whole adaptive run in one launch
//                           (rwrt_dense_run: tracer._dense_run on CUDA).
//                           Each lane walks every group of bounds, applies
//                           the kill cascade at each bound in bound order,
//                           samples (ug, vg) there and writes its rows
//                           straight into the run's (nt, 5, R) output.
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
// float32 peak. The real floor is latency: each lane is a serial chain of
// trips, each six dependent RHS evaluations (a dependent 48-value gather
// from the L2-resident background, IEEE division, sqrt, sin and cos) and a
// pow, so the launch lasts at least the longest lane's trips over all
// groups (910 in the production run) times the latency of one trip.
//
// Design: the batch-wide XLA loop becomes a per-lane loop, so a finished
// lane costs nothing but its warp slot and no launch is spent per trip or
// per group. Pin-kill retires a lane that reaches pin_limit attempts in a
// group, so no lane is the straggler of two groups: one launch pays the
// longest lane's total (910 trips) instead of the sum of each group's
// longest lane (2,642). One loop runs the trips and the group changes, so
// the lanes of a warp that are stepping run each trip together, whichever
// group each is in; a loop per group holds every lane at each group's end
// until the warp's slowest lane there is done. The stages stay in
// registers; emission walks a pointer over
// the (non-decreasing) bounds. The kill cascade runs at emission, in bound
// order, on the lane's own last alive position; the bounds a lane never
// reached are cascaded as death at the group's end, exactly as the plain
// post-pass reads the NaN-prefilled history. A killed lane keeps
// integrating to the group's end, so attempts and the truncation count
// equal the plain version's; its carry is NaNed after the group.
//
// Keep work out of the emission branch: it is divergent (each lane emits
// its own bounds, about three per trip), so what runs there is paid once
// per set of emitting lanes; the kill test's haversine and the (ug, vg)
// sample there cost the first design about half of its launch. So (ug, vg)
// is sampled after the lane's last group, the whole warp together, from
// the rows it wrote; the haversine runs only where a cheap bound cannot
// rule the kill out (ray_rhs.cuh kill_mask); and the background row comes
// in 16-byte loads.
//
// The Dormand-Prince stages, error norm and step factors are dp45.cuh's,
// shared with the exact kernels (exact_run.cu).
//
// Types: the state S (y, t, h, the controller, the emitted rows, the kill
// cascade, (ug, vg)) and the background F (the RHS, the stages k, the FSAL
// carry f): dense_kernel<T, T, kRun> is the one-type kernel;
// dense_kernel<double, float, true> the mixed-precision whole run and
// dense_kernel<double, float, false> its single group (the _mix entry
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
  // at exit; the haversine kill threshold.
  const S* ug0;
  const S* vg0;
  S* ugs;
  S* vgs;
  int* trunc;
  S* plon;
  S* plat;
  S cut_off;
};

template <typename S, typename F, bool kRun, bool kTime>
__global__ void __launch_bounds__(128)
dense_kernel(const DenseArgs<S, F, kTime> a) {
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

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.R) return;
  const auto& bg = rwrt::lane_background(a.bg, i);
  const long long RL = a.R;
  const int G = a.G;
  const S nan = rwrt::nan_value<S>();

  S yl[5];
  F fl[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    yl[v] = a.y[v * RL + i];
    fl[v] = a.f[v * RL + i];
  }
  S tl = a.t[i];
  S hl = a.h[i];
  bool rej = false;
  bool ns = true;

  // Kill-cascade state of the whole run: the lane's last alive emitted
  // position, and whether it is alive in the current group.
  S plon = yl[0];
  S plat = yl[1];
  bool alive = true;
  int trunc = 0;
  if constexpr (kRun) {
#pragma unroll
    for (int v = 0; v < 5; ++v) a.hist[v * RL + i] = yl[v];
    a.ugs[i] = a.ug0[i];
    a.vgs[i] = a.vg0[i];
  }

  // The current group g (-1 before the first): its bounds, final time,
  // first output row, entry freeze, next bound to emit, and attempts.
  int g = -1;
  const S* bounds = a.bounds;
  S t_end = tl;  // no trip before the first group opens
  long long row0 = 0;
  bool frozen = false;
  int nb = 0;
  int att = 0;
  auto store = [&](int b, const S row[5]) {
#pragma unroll
    for (int v = 0; v < 5; ++v) a.hist[((row0 + b) * 5 + v) * RL + i] = row[v];
  };
  // A NaN row: an unreached bound, or one the cascade killed.
  auto store_dead = [&](int b) {
    const S row[5] = {nan, nan, nan, nan, nan};
    store(b, row);
    if constexpr (kRun) alive = false;
  };
  const S floor_thr = a.min_step * S(1.0 + 1e-6);

  // ONE loop over the trips and the group changes, so the lanes of a warp
  // that are stepping run each trip together, whichever group each is in
  // (a loop per group holds them at each group's end).
  for (;;) {
    if (!(tl < t_end) || static_cast<long long>(att) >= a.max_iters) {
      if (g >= 0) {
        // Close group g. Bounds the lane never reached stay NaN: death,
        // in bound order.
        if (!frozen) {
          for (int b = nb; b < G; ++b) store_dead(b);
        }
        if constexpr (kRun) {
          // Counted at integration end, before the carry's NaN: a lane
          // the backstop stopped short while alive.
          if (tl < t_end && !isnan(yl[0])) ++trunc;
          if (!alive && !frozen) {
#pragma unroll
            for (int v = 0; v < 5; ++v) yl[v] = nan;
          }
        }
        a.lane_att[g * RL + i] = att;
      }
      if (++g == a.n_groups) break;
      // Open group g.
      bounds = a.bounds + static_cast<long long>(g) * G;
      t_end = __ldg(bounds + G - 1);
      row0 = kRun ? 1 + static_cast<long long>(g) * G : 0;
      // Entry state: any NaN component (isnan(mean(y))) freezes the lane
      // at its entry state for every bound, outside the cascade.
      frozen = isnan((yl[0] + yl[1] + yl[2] + yl[3] + yl[4]) / S(5));
      alive = !frozen;
      if (frozen) {
        for (int b = 0; b < G; ++b) store(b, yl);
        tl = t_end;
      }
      rej = false;
      ns = true;
      att = 0;
      // First bound strictly after t (bounds are non-decreasing); a live
      // lane never emits the bounds before it.
      nb = 0;
      while (nb < G && !(__ldg(bounds + nb) > tl)) ++nb;
      if (!frozen) {
        for (int b = 0; b < nb; ++b) store_dead(b);
      }
    } else {
      // One trip of group g.
      const S heff = ns ? nan_max(hl, a.min_step) : hl;
      const S t_new = nan_min(tl + heff, t_end);
      const S hs = t_new - tl;

      F k[7][5];
#pragma unroll
      for (int v = 0; v < 5; ++v) k[0][v] = fl[v];
      S y_new[5];
      rwrt::dp45::trial(bg, yl, tl, hs, k, y_new);
      bool e;
      F y7[5];
#pragma unroll
      for (int v = 0; v < 5; ++v) y7[v] = F(y_new[v]);
      F t7 = F(0);  // the 7th stage's time (time instances only)
      if constexpr (kTime) t7 = F(t_new);
      rwrt::ray_rhs(bg, y7, t7, k[6], &e);
      const S error_norm =
          rwrt::dp45::error_norm(k, hs, yl, y_new, a.atol, a.rtol);

      const bool nan_err = isnan(error_norm);
      const bool dead_now = isnan(yl[0]);
      const bool at_floor = hs <= a.min_step;
      const bool accept =
          nan_err ? (dead_now || at_floor) : (error_norm < S(1));
      S fac_acc, fac_rej;
      rwrt::dp45::step_factors(error_norm, rej, &fac_acc, &fac_rej);
      if (nan_err) fac_acc = S(1);
      if (nan_err) fac_rej = S(rwrt::dp45::kMinFactor);
      const S h_next = accept ? hs * fac_acc : hs * fac_rej;

      if (accept) {
        // Dense emission: every bound in (t, t_new] from the quartic
        // interpolant of this step's stages.
        const S hden = (hs == S(0)) ? S(1) : hs;
        while (nb < G) {
          const S bnd = __ldg(bounds + nb);
          if (!(bnd <= t_new)) break;
          const S th = (bnd - tl) / hden;
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
            row[v] = yl[v] + hs * acc;
          }
          if constexpr (kRun) {
            // Kill cascade at this bound.
            if (!alive || isnan(row[0]) ||
                rwrt::kill_mask(row, plon, plat, a.cut_off)) {
              store_dead(nb);
            } else {
              store(nb, row);
              plon = row[0];
              plat = row[1];
            }
          } else {
            store(nb, row);
          }
          ++nb;
        }
      }

      S y_out[5];
#pragma unroll
      for (int v = 0; v < 5; ++v) y_out[v] = accept ? y_new[v] : yl[v];
      S t_out = accept ? t_new : tl;

      // Straggler pin-kill: accepted steps and rejections at the step floor.
      att += 1;
      const bool floor_rej = !accept && (hs <= floor_thr);
      // The pin row is ky (state row 3), as in the plain version.
      const bool retire = (accept || floor_rej) &&
                          (static_cast<long long>(att) >= a.pin_limit) &&
                          (fabs(y_out[3]) >= a.pin_mwn);
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
  }

#pragma unroll
  for (int v = 0; v < 5; ++v) {
    a.y[v * RL + i] = yl[v];
    a.f[v * RL + i] = fl[v];
  }
  a.t[i] = tl;
  a.h[i] = hl;
  if constexpr (kRun) {
    // (ug, vg) at every row, after the lane's last group: the warp's lanes
    // have all left the loop, so they sample together, each its own rows
    // (neighbouring lanes, neighbouring addresses).
    const long long rows = static_cast<long long>(a.n_groups) * G;
    for (long long r = 1; r <= rows; ++r) {
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
    a.trunc[i] = trunc;
    a.plon[i] = plon;
    a.plat[i] = plat;
  } else {
    a.rejected[i] = rej;
    a.new_step[i] = ns;
  }
}

template <typename S, typename F, bool kRun, bool kTime>
int launch_dense(const DenseArgs<S, F, kTime>& a, cudaStream_t stream) {
  if (a.R <= 0 || a.G <= 0 || a.n_groups <= 0) return cudaSuccess;
  const int block = 128;
  const int grid = (a.R + block - 1) / block;
  dense_kernel<S, F, kRun, kTime><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
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
  return launch_dense<S, F, true, kTime>(a, static_cast<cudaStream_t>(stream));
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
  return launch_dense<S, F, false, kTime>(a,
                                          static_cast<cudaStream_t>(stream));
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

// The whole run, state type S over background type F.
#define RWRT_DENSE_RUN(SUFFIX, S, F)                                         \
  int rwrt_dense_run_##SUFFIX(                                               \
      const void* packed, int W, int H, double lon0, double lat0, double dx, \
      double dy, void* y, void* t, void* h, void* f, const void* ug0,        \
      const void* vg0, void* hist, void* ugs, void* vgs, void* lane_att,     \
      void* trunc, void* plon, void* plat, const void* bounds, int G,        \
      int n_groups, int R, double cut_off, double rtol, double atol,         \
      double min_step, long long max_iters, long long pin_limit,             \
      double pin_mwn, void* stream) {                                        \
    return run_dense<S, F>(                                                  \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy), y, t, h, \
        f, ug0, vg0, hist, ugs, vgs, lane_att, trunc, plon, plat, bounds, G, \
        n_groups, R, cut_off, rtol, atol, min_step, max_iters, pin_limit,    \
        pin_mwn, stream);                                                    \
  }

// Its time instance: the background's time axis and member map after the
// grid.
#define RWRT_DENSE_RUN_TIME(SUFFIX, S, F)                                    \
  int rwrt_dense_run_time_##SUFFIX(                                          \
      const void* packed, int W, int H, double lon0, double lat0, double dx, \
      double dy, int nt, int timed, double t0, double tdt,                   \
      const void* member, void* y, void* t, void* h, void* f,                \
      const void* ug0, const void* vg0, void* hist, void* ugs, void* vgs,    \
      void* lane_att, void* trunc, void* plon, void* plat,                   \
      const void* bounds, int G, int n_groups, int R, double cut_off,        \
      double rtol, double atol, double min_step, long long max_iters,        \
      long long pin_limit, double pin_mwn, void* stream) {                   \
    return run_dense<S, F>(                                                  \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy, nt,       \
                                 timed, t0, tdt, member),                    \
        y, t, h, f, ug0, vg0, hist, ugs, vgs, lane_att, trunc, plon, plat,   \
        bounds, G, n_groups, R, cut_off, rtol, atol, min_step, max_iters,    \
        pin_limit, pin_mwn, stream);                                         \
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
