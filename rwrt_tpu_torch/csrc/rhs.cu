// RHS kernel: dy/dt of every lane of a (5, R) ray state.
//
// Replaces (rwrt_tpu): models/ray.py rhs / rhs_and_gv over _rhs_core, with
// interp._packed_cell, _packed_corner_lerp, mercator_transform and
// groupvel.group_velocity_core fused in (XLA fused these on the TPU; there
// is no Pallas original). Plain PyTorch version: rwrt_tpu_torch/models/ray.py
// _rhs_core. Used for the initial FSAL stage f0 and by select_initial_step;
// the dense kernels (dense_run.cu) call the same __device__ function inline.
//
// What bounds it on an H100: per lane 40 B of state in, 41-57 B out and one
// 192 B (float32) row gathered from the ~2 MB packed background, which stays
// L2-resident; at 10^5 lanes a launch moves ~25 MB and is memory-latency
// bound. Design: one thread per lane, state and outputs in the (5, R)
// layout so neighbouring threads touch neighbouring addresses (coalesced),
// the shared background read through the read-only cache (ray_rhs.cuh).
// Built with -fmad=false, so it rounds as _rhs_core's separate ops do.
#include <cuda_runtime.h>

#include "ray_rhs.cuh"

namespace {

template <typename T>
__global__ void rhs_kernel(rwrt::Background<T> bg, const T* __restrict__ y,
                           int R, T* __restrict__ dy,
                           bool* __restrict__ err, T* __restrict__ ug,
                           T* __restrict__ vg) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  T yl[5], dl[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) yl[v] = y[static_cast<long long>(v) * R + i];
  bool e;
  if (ug != nullptr) {
    T u, w;
    rwrt::ray_rhs(bg, yl, dl, &e, &u, &w);
    ug[i] = u;
    vg[i] = w;
  } else {
    rwrt::ray_rhs(bg, yl, dl, &e);
  }
#pragma unroll
  for (int v = 0; v < 5; ++v) dy[static_cast<long long>(v) * R + i] = dl[v];
  err[i] = e;
}

template <typename T>
int launch_rhs(const T* packed, int W, int H, double lon0, double lat0,
               double dx, double dy_, const T* y, int R, T* dy, bool* err,
               T* ug, T* vg, cudaStream_t stream) {
  if (R <= 0) return cudaSuccess;
  rwrt::Background<T> bg{packed, W, H, T(lon0), T(lat0), T(dx), T(dy_)};
  const int block = 128;
  const int grid = (R + block - 1) / block;
  rhs_kernel<T><<<grid, block, 0, stream>>>(bg, y, R, dy, err, ug, vg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int rwrt_rhs_f32(const void* packed, int W, int H, double lon0, double lat0,
                 double dx, double dy_, const void* y, int R, void* dy,
                 void* err, void* ug, void* vg, void* stream) {
  return launch_rhs(static_cast<const float*>(packed), W, H, lon0, lat0, dx,
                    dy_, static_cast<const float*>(y), R,
                    static_cast<float*>(dy), static_cast<bool*>(err),
                    static_cast<float*>(ug), static_cast<float*>(vg),
                    static_cast<cudaStream_t>(stream));
}

int rwrt_rhs_f64(const void* packed, int W, int H, double lon0, double lat0,
                 double dx, double dy_, const void* y, int R, void* dy,
                 void* err, void* ug, void* vg, void* stream) {
  return launch_rhs(static_cast<const double*>(packed), W, H, lon0, lat0, dx,
                    dy_, static_cast<const double*>(y), R,
                    static_cast<double*>(dy), static_cast<bool*>(err),
                    static_cast<double*>(ug), static_cast<double*>(vg),
                    static_cast<cudaStream_t>(stream));
}

const char* rwrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
