// The adaptive runs' entry stage in one launch: the FSAL stage f0 =
// rhs(y0, t0) and Hairer's initial step h0, one thread per lane, in
// registers.
//
//   entry_kernel<S, F, kTime>   rwrt_entry (and rwrt_entry_time over a
//                               time-varying or ensemble background):
//                               tracer.entry_stage on CUDA.
//
// Replaces (rwrt_tpu, fused by XLA there, no Pallas original):
//   tracer.py:809-816 initial_step_sizes over solvers/rk45.py:95
//   select_initial_step (the scale, the RMS norms d0 and d1, h0 with the
//   1e-5 smallness rule, y1 and f1 = rhs(y1, t0 + h0), d2, fmax, h1 =
//   (0.01 / dm)^(1/5) with the both-small rule, min(100 h0, h1)) and the
//   FSAL stage beside it (tracer.py:878-880, termination.py:164-174).
// Plain PyTorch version: rwrt_tpu_torch/tracer.py _entry_stage_plain,
// which is that composition over models/ray.py _rhs_core; this follows
// its expressions and their order, including the ones PyTorch rewrites:
// a scalar over a tensor is the tensor's reciprocal times the scalar
// (Tensor.__rtruediv__), the norms sum their squares in row order and
// divide by 5 (rk45._norm), and NaN propagates as torch.minimum and
// torch.clamp propagate it (fmax does not).
//
// What bounds it on an H100. Per lane 5 state values (and a time) in, 5
// stage values and h0 out, and two evaluations of the RHS, each one
// 48-value row of the L2-resident background: at 60,784 lanes ~4.4 MB of
// state and ~1 MFLOP, ~0.002 ms at the memory's rate. What a launch costs
// is the chain of two dependent RHS evaluations (the second samples at
// y1, which needs h0, which needs f0) in one wave of threads: ~2 x 1 us.
// The work it replaces was 2-3 launches of the RHS kernel and ~35
// elementwise PyTorch ops between them, each a launch of its own.
//
// Design. One thread per lane, 128 a block; the RHS is ray_rhs.cuh's,
// the state/field type split dp45.cuh's: S the state's type (y0, t0, the
// norms, h0 and h), F the background's (f0, f1 and the RHS's input, the
// state and times rounded to F). With S == F every cast is the identity;
// in mixed precision (S double, F float) f1 - f0 is taken in F and
// widened, as the JAX package's promotion has it. The float64 pow is
// PyTorch's, inline (pow64.cuh). Built with -fmad=false, so each
// expression rounds as the plain version's separate tensor ops do.
#include <cuda_runtime.h>

#include <type_traits>

#include "dp45.cuh"

namespace {

using rwrt::dp45::nan_min;

template <typename S, typename F, bool kTime>
struct EntryArgs {
  rwrt::Background<F, kTime> bg;
  const S* y;  // (5, R)
  const S* t;  // (R,): each lane's time (time instances only)
  int R;
  S rtol, atol;
  F* f0;  // (5, R): rhs(y0, t0)
  S* h;   // (R,): the initial step
};

// x^(1/5) as PyTorch's CUDA pow rounds it: powf in float32, libdevice's
// pow built with contraction in float64 (pow64.cuh).
template <typename S>
__device__ __forceinline__ S fifth_root(S x) {
  if constexpr (std::is_same<S, double>::value) {
    return rwrt::pow64(x, S(1.0 / 5.0));
  } else {
    return pow(x, S(1.0 / 5.0));
  }
}

// torch.sqrt(true_div(sum of squares in row order, 5)).
template <typename S>
__device__ __forceinline__ S rms(const S x[5]) {
  S sq = x[0] * x[0];
#pragma unroll
  for (int v = 1; v < 5; ++v) sq = sq + x[v] * x[v];
  return sqrt(sq / S(5));
}

template <typename S, typename F, bool kTime>
__global__ void __launch_bounds__(rwrt::kBlock)
    entry_kernel(const EntryArgs<S, F, kTime> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.R) return;
  const auto& bg = rwrt::lane_background(a.bg, i);
  const long long RL = a.R;

  S y0[5];
  F yf[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    y0[v] = a.y[v * RL + i];
    yf[v] = F(y0[v]);
  }
  S t0 = S(0);
  if constexpr (kTime) t0 = a.t[i];
  bool e;
  F f0[5];
  rwrt::ray_rhs<F>(bg, yf, F(t0), f0, &e);

  // scale = atol + |y0| rtol; d0 = ||y0 / scale||, d1 = ||f0 / scale||.
  S scale[5], x0[5], x1[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    scale[v] = a.atol + fabs(y0[v]) * a.rtol;
    x0[v] = y0[v] / scale[v];
    x1[v] = S(f0[v]) / scale[v];
  }
  const S d0 = rms(x0);
  const S d1 = rms(x1);
  S h0 = S(0.01) * d0 / d1;
  if (d0 < S(1e-5) || d1 < S(1e-5)) h0 = S(1e-6);

  // y1 = y0 + h0 f0; f1 = rhs(y1, t0 + h0); d2 = ||(f1 - f0) / scale|| / h0.
  F f1[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) yf[v] = F(y0[v] + h0 * S(f0[v]));
  rwrt::ray_rhs<F>(bg, yf, F(t0 + h0), f1, &e);
  S x2[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) x2[v] = S(f1[v] - f0[v]) / scale[v];
  const S d2 = rms(x2) / h0;

  const S dm = fmax(d1, d2);
  S h1 = fifth_root(S(1) / dm * S(0.01));
  if (!(d1 > S(1e-15)) && !(d2 > S(1e-15))) {
    const S small = h0 * S(1e-3);  // torch.clamp(small, min=1e-6)
    h1 = (isnan(small) || small > S(1e-6)) ? small : S(1e-6);
  }
  a.h[i] = nan_min(S(100) * h0, h1);
#pragma unroll
  for (int v = 0; v < 5; ++v) a.f0[v * RL + i] = f0[v];
}

template <typename S, typename F, bool kTime>
int run_entry(const rwrt::Background<F, kTime>& bg, const void* y,
              const void* t, int R, double rtol, double atol, void* f0,
              void* h, void* stream) {
  if (R <= 0) return cudaSuccess;
  EntryArgs<S, F, kTime> a{};
  a.bg = bg;
  a.y = static_cast<const S*>(y);
  a.t = static_cast<const S*>(t);
  a.R = R;
  a.rtol = S(rtol);
  a.atol = S(atol);
  a.f0 = static_cast<F*>(f0);
  a.h = static_cast<S*>(h);
  const int grid = (R + rwrt::kBlock - 1) / rwrt::kBlock;
  entry_kernel<S, F, kTime>
      <<<grid, rwrt::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define RWRT_ENTRY(SUFFIX, S, F)                                              \
  int rwrt_entry_##SUFFIX(const void* packed, int W, int H, double lon0,      \
                          double lat0, double dx, double dy, const void* y,   \
                          int R, double rtol, double atol, void* f0, void* h, \
                          void* stream) {                                     \
    return run_entry<S, F, false>(                                            \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy), y,        \
        nullptr, R, rtol, atol, f0, h, stream);                               \
  }
#define RWRT_ENTRY_TIME(SUFFIX, S, F)                                         \
  int rwrt_entry_time_##SUFFIX(                                               \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, int nt, int timed, double t0, double tdt,                    \
      const void* member, const void* y, const void* t, int R, double rtol,   \
      double atol, void* f0, void* h, void* stream) {                         \
    return run_entry<S, F, true>(                                             \
        rwrt::make_background<F>(packed, W, H, lon0, lat0, dx, dy, nt, timed, \
                                 t0, tdt, member),                            \
        y, t, R, rtol, atol, f0, h, stream);                                  \
  }

// One group of instances per translation unit, so that the four compile in
// parallel and the float32 ones stay whole-program: the static float32
// instance here, the static float64 and mixed ones in entry_f64.cu, the
// time instances in entry_time.cu and entry_time_f64.cu.
#if defined(RWRT_ENTRY_TIME_F64)
RWRT_ENTRY_TIME(f64, double, double)
RWRT_ENTRY_TIME(mix, double, float)
#elif defined(RWRT_ENTRY_TIME_F32)
RWRT_ENTRY_TIME(f32, float, float)
#elif defined(RWRT_ENTRY_F64)
RWRT_ENTRY(f64, double, double)
RWRT_ENTRY(mix, double, float)
#else
RWRT_ENTRY(f32, float, float)
#endif

#undef RWRT_ENTRY
#undef RWRT_ENTRY_TIME

}  // extern "C"
