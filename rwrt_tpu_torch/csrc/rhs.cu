// RHS kernel: dy/dt of every lane of a (5, R) ray state.
//
// Replaces (rwrt_tpu): models/ray.py rhs / rhs_and_gv over _rhs_core, with
// interp._packed_cell, _packed_corner_lerp, mercator_transform and
// groupvel.group_velocity_core fused in (XLA fused these on the TPU; there
// is no Pallas original). Plain PyTorch version: rwrt_tpu_torch/models/ray.py
// _rhs_core. Launched by ray.rhs and ray.rhs_and_gv (public; no run path
// launches it: the RK4 re-run of --report-exact is one launch of
// rk4_run.cu's step kernel); every integrator kernel and the adaptive runs'
// entry stage (entry.cu) call the same __device__ function inline.
//
// What bounds it on an H100: per lane 40 B of state in, 41-57 B out and one
// 192 B (float32) row gathered from the ~2 MB packed background, which stays
// L2-resident: each input read once and each output written once, ~6 MB
// at 100,800 lanes, under 2 us at the memory's rate. Above that sits one evaluation's dependent chain (a lone lane's time,
// the chain floor: the gather, the sin and cos, 14 IEEE divisions one
// after another in Lane), which a launch of a few thousand lanes cannot
// hide. Design: the evaluation spreads over threads by instance
// (ray_rhs.cuh): Lane, one thread per lane, for full launches; Split,
// 8 threads a lane with the divisions in three groups, below
// kernels.RHS_TEAM_LANES' most, where the card has threads to spare and
// the chain is the launch. State and outputs in the (5, R) layout so
// neighbouring lanes touch neighbouring addresses (coalesced); a team's
// thread v stores the value v. The shared background is read through the
// read-only cache (ray_rhs.cuh). Built with -fmad=false, so it rounds as
// _rhs_core's separate ops do; every instance gives the same bits.
// The time instance (rhs_time.cu: a time-varying or ensemble background)
// takes each lane's time, (R,) in T, and its member (ray_rhs.cuh).
#include <cuda_runtime.h>

#include "ray_rhs.cuh"

namespace {

template <typename T, bool kTime>
struct RhsArgs {
  rwrt::Background<T, kTime> bg;
  const T* y;  // (5, R)
  const T* t;  // (R,): the time instance's lane times
  int R;
  T* dy;       // (5, R)
  bool* err;   // (R,)
  T* ug;       // (R,) or null: the raw group velocity's
  T* vg;
};

// The time instance (kTime) reads each lane's time t and member
// (rwrt::lane_background), the static one neither.
template <typename T, bool kTime, class I>
__global__ void __launch_bounds__(rwrt::kBlock)
    rhs_kernel(const RhsArgs<T, kTime> a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / I::kThreads;
  if (i >= a.R) return;
  const auto& bg = rwrt::lane_background(a.bg, i);
  const long long RL = a.R;
  T tl = T(0);
  if constexpr (kTime) tl = a.t[i];
  T yl[5], dl[7];
#pragma unroll
  for (int v = 0; v < 5; ++v) yl[v] = a.y[v * RL + i];
  bool e;
  const bool gv = a.ug != nullptr;
  if (gv) {
    rwrt::ray_rhs<T, I>(bg, yl, tl, dl, &e, &dl[5], &dl[6]);
  } else {
    rwrt::ray_rhs<T, I>(bg, yl, tl, dl, &e);
    dl[5] = dl[6] = T(0);
  }
  if constexpr (I::kThreads == 1) {
#pragma unroll
    for (int v = 0; v < 5; ++v) a.dy[v * RL + i] = dl[v];
    if (gv) {
      a.ug[i] = dl[5];
      a.vg[i] = dl[6];
    }
    a.err[i] = e;
  } else {
    const T x = I::template own<T, 7>(dl);
    const int v = I::rank();
    if (v < 5) {
      a.dy[v * RL + i] = x;
    } else if (v < 7) {
      if (gv) (v == 5 ? a.ug : a.vg)[i] = x;
    } else {
      a.err[i] = e;
    }
  }
}

template <typename T, bool kTime>
int launch_rhs(const rwrt::Background<T, kTime>& bg, const void* y,
               const void* t, int R, void* dy, void* err, void* ug, void* vg,
               int inst, void* stream) {
  if (R <= 0) return cudaSuccess;
  const RhsArgs<T, kTime> a{bg,
                            static_cast<const T*>(y),
                            static_cast<const T*>(t),
                            R,
                            static_cast<T*>(dy),
                            static_cast<bool*>(err),
                            static_cast<T*>(ug),
                            static_cast<T*>(vg)};
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::launch_as<I>(rhs_kernel<T, kTime, I>, a, R,
                              static_cast<cudaStream_t>(stream));
  });
}

// Resident threads of the kernel (ray.rhs_instance's occupancy count).
template <typename T, bool kTime>
int rhs_resident(int inst, int* out) {
  return rwrt::with_instance(inst, [&](auto tag) {
    using I = decltype(tag);
    return rwrt::resident_threads(rhs_kernel<T, kTime, I>, out);
  });
}

}  // namespace

extern "C" {

// The static entry points here; the time instances' (rhs_time.cu includes
// this file) in their own unit, so that the two compile in parallel.
#ifndef RWRT_RHS_TIME
#define RWRT_RHS(SUFFIX, T)                                                  \
  int rwrt_rhs_##SUFFIX(const void* packed, int W, int H, double lon0,       \
                        double lat0, double dx, double dy_, const void* y,   \
                        int R, void* dy, void* err, void* ug, void* vg,      \
                        int inst, void* stream) {                            \
    return launch_rhs(                                                       \
        rwrt::make_background<T>(packed, W, H, lon0, lat0, dx, dy_), y,      \
        nullptr, R, dy, err, ug, vg, inst, stream);                          \
  }                                                                          \
  int rwrt_rhs_resident_##SUFFIX(int inst, void* out) {                      \
    return rhs_resident<T, false>(inst, static_cast<int*>(out));             \
  }

RWRT_RHS(f32, float)
RWRT_RHS(f64, double)

const char* rwrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#else
#define RWRT_RHS(SUFFIX, T)                                                  \
  int rwrt_rhs_time_##SUFFIX(                                                \
      const void* packed, int W, int H, double lon0, double lat0, double dx, \
      double dy_, int nt, int timed, double t0, double tdt,                  \
      const void* member, const void* y, const void* t, int R, void* dy,     \
      void* err, void* ug, void* vg, int inst, void* stream) {               \
    return launch_rhs(                                                       \
        rwrt::make_background<T>(packed, W, H, lon0, lat0, dx, dy_, nt,      \
                                 timed, t0, tdt, member),                    \
        y, t, R, dy, err, ug, vg, inst, stream);                             \
  }                                                                          \
  int rwrt_rhs_resident_time_##SUFFIX(int inst, void* out) {                 \
    return rhs_resident<T, true>(inst, static_cast<int*>(out));              \
  }

RWRT_RHS(f32, float)
RWRT_RHS(f64, double)
#endif

#undef RWRT_RHS

}  // extern "C"
