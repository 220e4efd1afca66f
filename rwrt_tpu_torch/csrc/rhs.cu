// RHS kernel: dy/dt of every lane of a (5, R) ray state.
//
// Replaces (rwrt_tpu): models/ray.py rhs / rhs_and_gv over _rhs_core, with
// interp._packed_cell, _packed_corner_lerp, mercator_transform and
// groupvel.group_velocity_core fused in (XLA fused these on the TPU; there
// is no Pallas original). Plain PyTorch version: rwrt_tpu_torch/models/ray.py
// _rhs_core. Launched by ray.rhs and ray.rhs_and_gv (the RK4 re-run of
// --report-exact); every integrator kernel and the adaptive runs' entry
// stage (entry.cu) call the same __device__ function inline.
//
// What bounds it on an H100: per lane 40 B of state in, 41-57 B out and one
// 192 B (float32) row gathered from the ~2 MB packed background, which stays
// L2-resident; at 10^5 lanes a launch moves ~25 MB and is memory-latency
// bound. Design: one thread per lane, state and outputs in the (5, R)
// layout so neighbouring threads touch neighbouring addresses (coalesced),
// the shared background read through the read-only cache (ray_rhs.cuh).
// Built with -fmad=false, so it rounds as _rhs_core's separate ops do.
// The time instance (rhs_time.cu: a time-varying or ensemble background)
// takes each lane's time, (R,) in T, and its member (ray_rhs.cuh).
#include <cuda_runtime.h>

#include "ray_rhs.cuh"

namespace {

// One thread per lane; the time instance (kTime) reads each lane's time t
// and member (rwrt::lane_background), the static one neither.
template <typename T, bool kTime>
__global__ void rhs_kernel(rwrt::Background<T, kTime> bg_all,
                           const T* __restrict__ y, const T* __restrict__ t,
                           int R, T* __restrict__ dy,
                           bool* __restrict__ err, T* __restrict__ ug,
                           T* __restrict__ vg) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const auto& bg = rwrt::lane_background(bg_all, i);
  T tl = T(0);
  if constexpr (kTime) tl = t[i];
  T yl[5], dl[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) yl[v] = y[static_cast<long long>(v) * R + i];
  bool e;
  if (ug != nullptr) {
    T u, w;
    rwrt::ray_rhs(bg, yl, tl, dl, &e, &u, &w);
    ug[i] = u;
    vg[i] = w;
  } else {
    rwrt::ray_rhs(bg, yl, tl, dl, &e);
  }
#pragma unroll
  for (int v = 0; v < 5; ++v) dy[static_cast<long long>(v) * R + i] = dl[v];
  err[i] = e;
}

template <typename T, bool kTime>
int launch_rhs(const rwrt::Background<T, kTime>& bg, const void* y,
               const void* t, int R, void* dy, void* err, void* ug, void* vg,
               void* stream) {
  if (R <= 0) return cudaSuccess;
  const int block = 128;
  const int grid = (R + block - 1) / block;
  rhs_kernel<T, kTime><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      bg, static_cast<const T*>(y), static_cast<const T*>(t), R,
      static_cast<T*>(dy), static_cast<bool*>(err), static_cast<T*>(ug),
      static_cast<T*>(vg));
  return cudaGetLastError();
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
                        void* stream) {                                      \
    return launch_rhs(                                                       \
        rwrt::make_background<T>(packed, W, H, lon0, lat0, dx, dy_), y,      \
        nullptr, R, dy, err, ug, vg, stream);                                \
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
      void* err, void* ug, void* vg, void* stream) {                         \
    return launch_rhs(                                                       \
        rwrt::make_background<T>(packed, W, H, lon0, lat0, dx, dy_, nt,      \
                                 timed, t0, tdt, member),                    \
        y, t, R, dy, err, ug, vg, stream);                                   \
  }

RWRT_RHS(f32, float)
RWRT_RHS(f64, double)
#endif

#undef RWRT_RHS

}  // extern "C"
