// Fixed-step RK4 kernel: n_steps output steps of every lane in one launch,
// one thread per lane (rwrt_rk4_run: tracer._run_rk4 and tracer._rk4_chunk
// on CUDA).
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
// a step, 21 GFLOP there, 0.31 ms at the 67 TFLOP/s float32 peak. The real
// floor is latency: each step is four dependent RHS evaluations (a
// dependent 48-value gather from the L2-resident background, IEEE
// divisions, sin and cos) and a fifth sample, and every lane takes every
// step, so the launch lasts at least n_steps times the latency of one step
// of a warp.
//
// Design: the JAX scan becomes a per-lane loop; nothing is read back to the
// host. Every lane runs the same number of steps, so the warp stays
// converged and (ug, vg) is sampled in the loop, right after the step. The
// carry y is read at entry and written at exit, and step s goes to output
// row row_offset + s, so a chunked driver can run the steps in pieces; with
// ug0 / vg0 given, row row_offset - 1 receives the entry state and them
// (the run's row 0). The scalar factors come rounded from the wrapper (dt,
// 0.5 * dt and dt / 6 in T), as the plain version rounds them. Blocks of
// 128 threads. The kernel is templated on the evaluation's instance
// (ray_rhs.cuh: Lane, Split), which the wrapper chooses
// (tracer.rk4_instance): 8 threads per lane for the launches of some
// dozens to a few thousand lanes, one thread per lane elsewhere. In a
// team every thread runs the same steps on the same state and its first
// thread writes the rows.
//
// Rounding: built with -fmad=false (kernels/build.py), so each expression
// rounds as the plain version's separate tensor ops do.
#include <cuda_runtime.h>

#include "ray_rhs.cuh"

namespace {

template <typename T>
struct Rk4Args {
  rwrt::Background<T> bg;
  T* y;         // (5, R) carry: read at entry, written at exit
  const T* ug0;  // (R,) or null: row row_offset - 1's (ug, vg)
  const T* vg0;
  T* ys;        // (rows, 5, R)
  T* ugs;       // (rows, R)
  T* vgs;
  int n_steps;
  int row_offset;
  int R;
  T dt, half, sixth;  // dt, 0.5 * dt, dt / 6, rounded to T
  T cut_off;
};

template <typename T, class I>
__global__ void __launch_bounds__(rwrt::kBlock) rk4_kernel(const Rk4Args<T> a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / I::kThreads;
  if (i >= a.R) return;
  const bool lead = I::lead();
  const long long RL = a.R;
  const T nan = rwrt::nan_value<T>();

  T yl[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) yl[v] = a.y[v * RL + i];
  auto store = [&](long long r, const T row[5], T ug, T vg) {
    if (!lead) return;
#pragma unroll
    for (int v = 0; v < 5; ++v) a.ys[(r * 5 + v) * RL + i] = row[v];
    a.ugs[r * RL + i] = ug;
    a.vgs[r * RL + i] = vg;
  };
  if (a.ug0 != nullptr) store(a.row_offset - 1, yl, a.ug0[i], a.vg0[i]);

  for (int s = 0; s < a.n_steps; ++s) {
    T k1[5], k2[5], k3[5], k4[5], ys[5];
    bool m1, m2, m3, m4;
    rwrt::ray_rhs<T, I>(a.bg, yl, k1, &m1);
#pragma unroll
    for (int v = 0; v < 5; ++v) ys[v] = yl[v] + a.half * k1[v];
    rwrt::ray_rhs<T, I>(a.bg, ys, k2, &m2);
#pragma unroll
    for (int v = 0; v < 5; ++v) ys[v] = yl[v] + a.half * k2[v];
    rwrt::ray_rhs<T, I>(a.bg, ys, k3, &m3);
#pragma unroll
    for (int v = 0; v < 5; ++v) ys[v] = yl[v] + a.dt * k3[v];
    rwrt::ray_rhs<T, I>(a.bg, ys, k4, &m4);
    // A lane advances only if no stage raised the fail flag.
    const bool valid = !(m1 || m2 || m3 || m4);
    T yn[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const T sum = ((k1[v] + T(2) * k2[v]) + T(2) * k3[v]) + k4[v];
      yn[v] = valid ? yl[v] + a.sixth * sum : yl[v];
    }
    // The kill test against the previous carry (NaN there kills nothing).
    if (rwrt::kill_mask(yn, yl[0], yl[1], a.cut_off)) {
#pragma unroll
      for (int v = 0; v < 5; ++v) yn[v] = nan;
    }
    T ug, vg;
    rwrt::group_velocity_at<T, I>(a.bg, yn, &ug, &vg);
    store(a.row_offset + s, yn, ug, vg);
#pragma unroll
    for (int v = 0; v < 5; ++v) yl[v] = yn[v];
  }
  if (lead) {
#pragma unroll
    for (int v = 0; v < 5; ++v) a.y[v * RL + i] = yl[v];
  }
}

template <typename T>
int launch_rk4(const Rk4Args<T>& a, int inst, cudaStream_t stream) {
  if (a.R <= 0) return cudaSuccess;
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::launch_as<I>(rk4_kernel<T, I>, a, a.R, stream);
  });
}

template <typename T>
int rk4_resident(int inst, int* out) {
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::resident_threads(rk4_kernel<T, I>, out);
  });
}

}  // namespace

extern "C" {

#define RWRT_RK4(SUFFIX, T)                                                   \
  int rwrt_rk4_run_##SUFFIX(                                                  \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, void* y, const void* ug0, const void* vg0, void* ys,         \
      void* ugs, void* vgs, int n_steps, int row_offset, int R, double dt,    \
      double half, double sixth, double cut_off, int inst, void* stream) {    \
    Rk4Args<T> a{};                                                           \
    a.bg = rwrt::Background<T>{static_cast<const T*>(packed), W, H, T(lon0),  \
                               T(lat0), T(dx), T(dy)};                        \
    a.y = static_cast<T*>(y);                                                 \
    a.ug0 = static_cast<const T*>(ug0);                                       \
    a.vg0 = static_cast<const T*>(vg0);                                       \
    a.ys = static_cast<T*>(ys);                                               \
    a.ugs = static_cast<T*>(ugs);                                             \
    a.vgs = static_cast<T*>(vgs);                                             \
    a.n_steps = n_steps;                                                      \
    a.row_offset = row_offset;                                                \
    a.R = R;                                                                  \
    a.dt = T(dt);                                                             \
    a.half = T(half);                                                         \
    a.sixth = T(sixth);                                                       \
    a.cut_off = T(cut_off);                                                   \
    return launch_rk4<T>(a, inst, static_cast<cudaStream_t>(stream));         \
  }                                                                           \
  int rwrt_rk4_resident_##SUFFIX(int inst, void* out) {                       \
    return rk4_resident<T>(inst, static_cast<int*>(out));                     \
  }

RWRT_RK4(f32, float)
RWRT_RK4(f64, double)

#undef RWRT_RK4

}  // extern "C"
