// Fixed-step RK4 kernels:
//
//   rk4_kernel<S, F, kTime, I>       rwrt_rk4_run: n_steps output steps of
//                                    every lane in one launch
//                                    (tracer._run_rk4 and tracer._rk4_chunk
//                                    on CUDA);
//   rk4_step_kernel<S, F, kTime, I>  rwrt_rk4_step: ONE step of every lane
//                                    from its own time, no kill test, no
//                                    row (solvers/rk4.py rk4_step_rays on
//                                    CUDA: the RK4 re-run of
//                                    termination.cause_labels, that is
//                                    --report-exact's exact death causes).
//
// Replaces (rwrt_tpu, fused by XLA there, no Pallas original):
//   solvers/rk4.py:32-40 rk4_step (four RHS stages, the freeze-if-any-flag
//   update) and :43-91 trace, with tracer.py:155-169 _rk4_chunk and
//   :819-821 _run_rk4 (the kill test against the previous carry, (ug, vg)
//   at the new state, each step's row written into the output).
// Plain PyTorch version: rwrt_tpu_torch/solvers/rk4.py rk4_step and
// trace_into, whose expressions and order this follows.
//
// What bounds it on an H100. Bytes: the output, (rows, 5, R) states plus
// (rows, R) ug and vg: 7 values per lane and step, 0.61 GB in float32 for
// the 100,800-ray 30-day seeding (60,784 lanes after compaction, 361 rows),
// 0.18 ms at 3.35 TB/s. Operations, counted from the sources: per step four
// RHS evaluations of ~182 flops, 65 for the stage inputs and the update,
// ~9 for the kill test's cheap bound and ~138 for the (ug, vg) sample: ~940
// a step (the plain version's work; the shared sample is counted too), 21
// GFLOP there, 0.31 ms at the 67 TFLOP/s float32 peak. The real
// floor is latency: each step is four dependent RHS evaluations (a
// dependent 48-value gather from the L2-resident background, IEEE
// divisions, sin and cos), and every lane takes every step, so the launch
// lasts at least n_steps times the latency of one step of a warp.
//
// Design: the JAX scan becomes a per-lane loop; nothing is read back to the
// host. Every lane runs the same number of steps, so the warp stays
// converged. A row's (ug, vg) are group velocity at the new state, which
// the next step's first evaluation samples too: with one type the
// evaluation returns them (ray_rhs.cuh ray_rhs with ug_raw, vg_raw: the
// same sample, and the RHS's NaN masks at a dead, bad or NaN-wavenumber
// lane give group_velocity_at's), so no fifth sample sits on the step's
// chain; a time instance shares it where the next step's time t_start +
// (s + 1) dt equals the row's t_s + dt to the bit (every documented run:
// whole-second steps), one test a step that every lane takes alike, and
// samples apart elsewhere. In mixed precision the row's sample is at the
// float64 state and the evaluation at its float rounding, so they cannot
// share: the sample follows its step, as before (PERF.md section 6: issued
// beside the next evaluation it gained ~1 %, and lost 0.8 % in Lane). Row
// s is written in step s + 1 and the launch's last row after the loop,
// but in mixed precision in step s. The carry y is read at entry and
// written at exit, and step s goes to output row row_offset + s, so a
// chunked driver can run the steps in pieces; with ug0 / vg0 given, row
// row_offset - 1 receives the entry state and them (the run's row 0). The
// scalar factors come rounded from the wrapper (dt, 0.5 * dt and dt / 6
// in T), as the plain version rounds them. Blocks of 128 threads. The
// kernel is templated on the evaluation's instance (ray_rhs.cuh: Lane,
// Split), which the wrapper chooses (tracer.rk4_instance, by
// kernels.RK4_TEAM_LANES): 8 threads per lane for the launches of some
// dozens to a few thousand lanes, one thread per lane elsewhere. In a team
// every thread runs the same steps on the same state, and thread v stores
// the row's value v (5 and 6: ug, vg), so that a warp stores a row in one
// instruction.
//
// Types: the state S (the carry, the stage inputs before their rounding,
// the update, the kill test, (ug, vg) and the rows) and the background F
// (the RHS and the stages k). rk4_kernel<T, T, kTime, I> is the one-type
// kernel (float32 and float64 entry points); rk4_kernel<double, float,
// kTime, I> is mixed precision (the _mix entry points, compiled in
// rk4_run_mix.cu),
// where, as in the JAX package, each stage input y + (0.5 dt) k is a
// double product and sum rounded to float for the RHS, the sum
// k1 + 2 k2 + 2 k3 + k4 is float, and the update and (ug, vg) at the new
// state are double (ray_rhs.cuh group_velocity_at<S, F>).
//
// Time: step s of a launch is taken at t = t_start + s * dt in S, its
// stages at t, t + dt / 2 and t + dt (rounded to F for the RHS), its
// (ug, vg) at t + dt, as solvers/rk4.py forms them. Only the time
// instances (kTime: rk4_run_time.cu, rk4_run_time_mix.cu; a time-varying
// or ensemble background, ray_rhs.cuh) read it; the static instances'
// code is the code without it.
//
// The one-step kernel. Replaces (rwrt_tpu, fused by XLA there):
// diagnostics/termination.py:160-162 (the RK4 branch of classify's
// re-run) over solvers/rk4.py:32-40 rk4_step with per-lane t0. Plain
// PyTorch version: rwrt_tpu_torch/solvers/rk4.py rk4_step. Each dead
// ray's last saved state takes one step from its own time; the step's
// four stages were four launches of the RHS kernel with a dozen host-issued
// elementwise ops between them (the stage inputs, the widened sum, the
// freeze mask and its where), each lane waiting on none of the others.
// What bounds it: a re-run is a few hundred to a few thousand lanes, so
// the card is mostly idle and one lane's chain of four dependent
// evaluations is the launch's floor; bytes (the state in and out, the
// lanes' background rows) and flops (4 x 182 + 65 a lane) are far below
// it. Design: the step in registers, as rk4_kernel's, with the same
// expressions in the same order (mixed precision's stages rounded to F,
// their products in S; the freeze where any stage flags err), and the
// evaluation spread as rk4_kernel's by instance, which the wrapper chooses
// by lane count (kernels.RK4_STEP_TEAM_LANES): Split's three division
// waits an evaluation against Lane's fourteen shorten the chain, and its
// 8 threads a lane cost nothing while the card is idle. A team's thread v
// stores the state's value v.
//
// Rounding: built with -fmad=false (kernels/build.py), so each expression
// rounds as the plain version's separate tensor ops do.
#include <cuda_runtime.h>

#include <type_traits>

#include "ray_rhs.cuh"

namespace {

// The carry's model time: a time instance's argument only (a field more in
// the static instances' arguments costs their Split instance a register).
template <typename S, bool kTime>
struct Rk4Time {};
template <typename S>
struct Rk4Time<S, true> {
  S t_start;
};

template <typename S, typename F, bool kTime>
struct Rk4Args : Rk4Time<S, kTime> {
  rwrt::Background<F, kTime> bg;
  S* y;         // (5, R) carry: read at entry, written at exit
  const S* ug0;  // (R,) or null: row row_offset - 1's (ug, vg)
  const S* vg0;
  S* ys;        // (rows, 5, R)
  S* ugs;       // (rows, R)
  S* vgs;
  int n_steps;
  int row_offset;
  int R;
  S dt, half, sixth;  // dt, 0.5 * dt, dt / 6, rounded to S
  S cut_off;
};

// The bits of a time, to test two for the same value (-0 and 0 apart).
__device__ __forceinline__ long long time_bits(double t) {
  return __double_as_longlong(t);
}
__device__ __forceinline__ long long time_bits(float t) {
  return __float_as_int(t);
}

template <typename S, typename F, bool kTime, class I>
__global__ void __launch_bounds__(rwrt::kBlock)
    rk4_kernel(const Rk4Args<S, F, kTime> a) {
  constexpr bool kOneType = std::is_same<S, F>::value;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / I::kThreads;
  if (i >= a.R) return;
  const auto& bg = rwrt::lane_background(a.bg, i);
  const long long RL = a.R;
  const S nan = rwrt::nan_value<S>();

  S yl[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) yl[v] = a.y[v * RL + i];
  // Row r: the state and (ug, vg). A team spreads the seven stores over
  // its threads, thread v storing value v, so that the warp stores a row
  // in one instruction; one thread a lane stores all seven.
  auto store = [&](long long r, const S row[5], S ug, S vg) {
    if constexpr (I::kThreads == 1) {
#pragma unroll
      for (int v = 0; v < 5; ++v) a.ys[(r * 5 + v) * RL + i] = row[v];
      a.ugs[r * RL + i] = ug;
      a.vgs[r * RL + i] = vg;
    } else {
      const S vals[7] = {row[0], row[1], row[2], row[3], row[4], ug, vg};
      const S x = I::template own<S, 7>(vals);
      const int v = I::rank();
      S* const out = v < 5 ? a.ys + (r * 5 + v) * RL
                           : (v == 5 ? a.ugs : a.vgs) + r * RL;
      if (v < 7) out[i] = x;
    }
  };
  if (a.ug0 != nullptr) store(a.row_offset - 1, yl, a.ug0[i], a.vg0[i]);

  // One type: row s's (ug, vg) are sampled at step s + 1's state yl and
  // time t_gv = t_s + dt, by step s + 1's first evaluation where it
  // samples the same point (a time instance: where its time t_start +
  // (s + 1) dt is t_gv to the bit); the last row's after the loop.
  S t_gv = S(0);
  for (int s = 0; s < a.n_steps; ++s) {
    // The step's sample times (time instances only; a static sample reads
    // none): t, t + dt / 2 and t + dt, rounded to F for the RHS.
    S t = S(0), t_end = S(0);
    F t_a = F(0), t_b = F(0), t_c = F(0);
    if constexpr (kTime) {
      t = a.t_start + S(s) * a.dt;
      t_end = t + a.dt;
      t_a = F(t);
      t_b = F(t + a.half);
      t_c = F(t_end);
    }
    F k1[5], k2[5], k3[5], k4[5], ys[5];
    bool m1, m2, m3, m4;
#pragma unroll
    for (int v = 0; v < 5; ++v) ys[v] = F(yl[v]);
    if constexpr (kOneType) {
      S ug, vg;
      // One test a step, the same in every lane.
      if (kTime && s > 0 && time_bits(t) != time_bits(t_gv)) {
        rwrt::group_velocity_at<S, F, I>(bg, yl, t_gv, &ug, &vg);
        rwrt::ray_rhs<F, I>(bg, ys, t_a, k1, &m1);
      } else {
        rwrt::ray_rhs<F, I>(bg, ys, t_a, k1, &m1, &ug, &vg);
      }
      if (s > 0) store(a.row_offset + s - 1, yl, ug, vg);
    } else {
      rwrt::ray_rhs<F, I>(bg, ys, t_a, k1, &m1);
    }
#pragma unroll
    for (int v = 0; v < 5; ++v) ys[v] = F(yl[v] + a.half * S(k1[v]));
    rwrt::ray_rhs<F, I>(bg, ys, t_b, k2, &m2);
#pragma unroll
    for (int v = 0; v < 5; ++v) ys[v] = F(yl[v] + a.half * S(k2[v]));
    rwrt::ray_rhs<F, I>(bg, ys, t_b, k3, &m3);
#pragma unroll
    for (int v = 0; v < 5; ++v) ys[v] = F(yl[v] + a.dt * S(k3[v]));
    rwrt::ray_rhs<F, I>(bg, ys, t_c, k4, &m4);
    // A lane advances only if no stage raised the fail flag.
    const bool valid = !(m1 || m2 || m3 || m4);
    S yn[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const F sum = ((k1[v] + F(2) * k2[v]) + F(2) * k3[v]) + k4[v];
      yn[v] = valid ? yl[v] + a.sixth * S(sum) : yl[v];
    }
    // The kill test against the previous carry (NaN there kills nothing).
    if (rwrt::kill_mask(yn, yl[0], yl[1], a.cut_off)) {
#pragma unroll
      for (int v = 0; v < 5; ++v) yn[v] = nan;
    }
    if constexpr (!kOneType) {
      S ug, vg;
      rwrt::group_velocity_at<S, F, I>(bg, yn, t_end, &ug, &vg);
      store(a.row_offset + s, yn, ug, vg);
    }
#pragma unroll
    for (int v = 0; v < 5; ++v) yl[v] = yn[v];
    t_gv = t_end;
  }
  if (kOneType && a.n_steps > 0) {
    S ug, vg;
    rwrt::group_velocity_at<S, F, I>(bg, yl, t_gv, &ug, &vg);
    store(a.row_offset + a.n_steps - 1, yl, ug, vg);
  }
  if (I::lead()) {
#pragma unroll
    for (int v = 0; v < 5; ++v) a.y[v * RL + i] = yl[v];
  }
}

template <typename S, typename F, bool kTime>
int launch_rk4(const Rk4Args<S, F, kTime>& a, int inst, cudaStream_t stream) {
  if (a.R <= 0) return cudaSuccess;
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::launch_as<I>(rk4_kernel<S, F, kTime, I>, a, a.R, stream);
  });
}

template <typename S, typename F, bool kTime>
int rk4_resident(int inst, int* out) {
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::resident_threads(rk4_kernel<S, F, kTime, I>, out);
  });
}

template <typename S, typename F, typename B>
int run_rk4(const B& bg, void* y, const void* ug0, const void* vg0, void* ys,
            void* ugs, void* vgs, int n_steps, int row_offset, int R,
            double dt, double half, double sixth, double cut_off,
            double t_start, int inst, void* stream) {
  constexpr bool kTime = std::is_same<B, rwrt::Background<F, true>>::value;
  Rk4Args<S, F, kTime> a{};
  a.bg = bg;
  a.y = static_cast<S*>(y);
  a.ug0 = static_cast<const S*>(ug0);
  a.vg0 = static_cast<const S*>(vg0);
  a.ys = static_cast<S*>(ys);
  a.ugs = static_cast<S*>(ugs);
  a.vgs = static_cast<S*>(vgs);
  a.n_steps = n_steps;
  a.row_offset = row_offset;
  a.R = R;
  a.dt = S(dt);
  a.half = S(half);
  a.sixth = S(sixth);
  a.cut_off = S(cut_off);
  if constexpr (kTime) a.t_start = S(t_start);
  return launch_rk4<S, F, kTime>(a, inst, static_cast<cudaStream_t>(stream));
}

// The one-step kernel's arguments: the (5, R) state y, each lane's time
// t0 (R,) (time instances only), the (5, R) result.
template <typename S, typename F, bool kTime>
struct Rk4StepArgs {
  rwrt::Background<F, kTime> bg;
  const S* y;
  const S* t0;
  S* out;
  int R;
  S dt, half, sixth;  // dt, 0.5 * dt, dt / 6, rounded to S
};

template <typename S, typename F, bool kTime, class I>
__global__ void __launch_bounds__(rwrt::kBlock)
    rk4_step_kernel(const Rk4StepArgs<S, F, kTime> a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / I::kThreads;
  if (i >= a.R) return;
  const auto& bg = rwrt::lane_background(a.bg, i);
  const long long RL = a.R;
  S yl[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) yl[v] = a.y[v * RL + i];
  // The stages' times t0, t0 + dt / 2 and t0 + dt in S, rounded to F.
  F t_a = F(0), t_b = F(0), t_c = F(0);
  if constexpr (kTime) {
    const S t = a.t0[i];
    t_a = F(t);
    t_b = F(t + a.half);
    t_c = F(t + a.dt);
  }
  F k1[5], k2[5], k3[5], k4[5], ys[5];
  bool m1, m2, m3, m4;
#pragma unroll
  for (int v = 0; v < 5; ++v) ys[v] = F(yl[v]);
  rwrt::ray_rhs<F, I>(bg, ys, t_a, k1, &m1);
#pragma unroll
  for (int v = 0; v < 5; ++v) ys[v] = F(yl[v] + a.half * S(k1[v]));
  rwrt::ray_rhs<F, I>(bg, ys, t_b, k2, &m2);
#pragma unroll
  for (int v = 0; v < 5; ++v) ys[v] = F(yl[v] + a.half * S(k2[v]));
  rwrt::ray_rhs<F, I>(bg, ys, t_b, k3, &m3);
#pragma unroll
  for (int v = 0; v < 5; ++v) ys[v] = F(yl[v] + a.dt * S(k3[v]));
  rwrt::ray_rhs<F, I>(bg, ys, t_c, k4, &m4);
  const bool valid = !(m1 || m2 || m3 || m4);
  S yn[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const F sum = ((k1[v] + F(2) * k2[v]) + F(2) * k3[v]) + k4[v];
    yn[v] = valid ? yl[v] + a.sixth * S(sum) : yl[v];
  }
  if constexpr (I::kThreads == 1) {
#pragma unroll
    for (int v = 0; v < 5; ++v) a.out[v * RL + i] = yn[v];
  } else {
    const S x = I::template own<S, 5>(yn);
    const int v = I::rank();
    if (v < 5) a.out[v * RL + i] = x;
  }
}

template <typename S, typename F, typename B>
int run_rk4_step(const B& bg, const void* y, const void* t0, void* out, int R,
                 double dt, double half, double sixth, int inst,
                 void* stream) {
  constexpr bool kTime = std::is_same<B, rwrt::Background<F, true>>::value;
  if (R <= 0) return cudaSuccess;
  Rk4StepArgs<S, F, kTime> a{};
  a.bg = bg;
  a.y = static_cast<const S*>(y);
  a.t0 = static_cast<const S*>(t0);
  a.out = static_cast<S*>(out);
  a.R = R;
  a.dt = S(dt);
  a.half = S(half);
  a.sixth = S(sixth);
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::launch_as<I>(rk4_step_kernel<S, F, kTime, I>, a, R,
                              static_cast<cudaStream_t>(stream));
  });
}

template <typename S, typename F, bool kTime>
int rk4_step_resident(int inst, int* out) {
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::resident_threads(rk4_step_kernel<S, F, kTime, I>, out);
  });
}

}  // namespace

extern "C" {

// S the state's type, F the background's.
#define RWRT_RK4(SUFFIX, S, F)                                                \
  int rwrt_rk4_run_##SUFFIX(                                                  \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, void* y, const void* ug0, const void* vg0, void* ys,         \
      void* ugs, void* vgs, int n_steps, int row_offset, int R, double dt,    \
      double half, double sixth, double cut_off, int inst, void* stream) {    \
    return run_rk4<S, F>(                                                     \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy), y, ug0,   \
        vg0, ys, ugs, vgs, n_steps, row_offset, R, dt, half, sixth, cut_off,  \
        0.0, inst, stream);                                                   \
  }                                                                           \
  int rwrt_rk4_resident_##SUFFIX(int inst, void* out) {                       \
    return rk4_resident<S, F, false>(inst, static_cast<int*>(out));           \
  }                                                                           \
  int rwrt_rk4_step_##SUFFIX(const void* packed, int W, int H, double lon0,   \
                             double lat0, double dx, double dy,               \
                             const void* y, void* out, int R, double dt,      \
                             double half, double sixth, int inst,             \
                             void* stream) {                                  \
    return run_rk4_step<S, F>(                                                \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy), y,        \
        nullptr, out, R, dt, half, sixth, inst, stream);                      \
  }                                                                           \
  int rwrt_rk4_step_resident_##SUFFIX(int inst, void* out) {                  \
    return rk4_step_resident<S, F, false>(inst, static_cast<int*>(out));      \
  }

// The time instances: the background's time axis and member map after the
// grid, the carry's time after cut_off.
#define RWRT_RK4_RUN_TIME(SUFFIX, S, F)                                       \
  int rwrt_rk4_run_time_##SUFFIX(                                             \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, int nt, int timed, double t0, double tdt,                    \
      const void* member, void* y, const void* ug0, const void* vg0,          \
      void* ys, void* ugs, void* vgs, int n_steps, int row_offset, int R,     \
      double dt, double half, double sixth, double cut_off, double t_start,   \
      int inst, void* stream) {                                               \
    return run_rk4<S, F>(                                                     \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy, nt, timed, \
                                 t0, tdt, member),                            \
        y, ug0, vg0, ys, ugs, vgs, n_steps, row_offset, R, dt, half, sixth,   \
        cut_off, t_start, inst, stream);                                      \
  }                                                                           \
  int rwrt_rk4_resident_time_##SUFFIX(int inst, void* out) {                  \
    return rk4_resident<S, F, true>(inst, static_cast<int*>(out));            \
  }                                                                           \
  int rwrt_rk4_step_time_##SUFFIX(                                            \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, int nt, int timed, double t0, double tdt,                    \
      const void* member, const void* y, const void* t, void* out, int R,     \
      double dt, double half, double sixth, int inst, void* stream) {         \
    return run_rk4_step<S, F>(                                                \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy, nt, timed, \
                                 t0, tdt, member),                            \
        y, t, out, R, dt, half, sixth, inst, stream);                         \
  }                                                                           \
  int rwrt_rk4_step_resident_time_##SUFFIX(int inst, void* out) {             \
    return rk4_step_resident<S, F, true>(inst, static_cast<int*>(out));       \
  }

// One group of entry points per unit, so that they compile in parallel:
// the one-type static ones here; rk4_run_mix.cu, rk4_run_time.cu and
// rk4_run_time_mix.cu include this file for the others.
#if defined(RWRT_RK4_TIME_MIX)
RWRT_RK4_RUN_TIME(mix, double, float)
#elif defined(RWRT_RK4_TIME)
RWRT_RK4_RUN_TIME(f32, float, float)
RWRT_RK4_RUN_TIME(f64, double, double)
#elif defined(RWRT_RK4_MIX)
RWRT_RK4(mix, double, float)
#else
RWRT_RK4(f32, float, float)
RWRT_RK4(f64, double, double)
#endif

#undef RWRT_RK4
#undef RWRT_RK4_RUN_TIME

}  // extern "C"
