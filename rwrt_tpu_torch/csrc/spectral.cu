// Spectral sampler kernel: evaluate the tensor-product spectral background
//
//   out[r, c] = sum_l cos(l * tht[r]) * sum_m blon[r, m] * coeffs[m, l*C + c]
//
// with blon[r] = [1, cos(m lon[r]), sin(m lon[r])] (m = 1..M), rows with
// |lat| > pi/2 NaN.
//
// Replaces (rwrt_tpu): ops/spectral_sample.py sample_spectral_pallas and its
// Pallas body _spectral_kernel (the package's one Pallas kernel). Plain
// PyTorch version: rwrt_tpu_torch/ops/spectral_sample.py sample_spectral.
//
// What bounds it on an H100: Mp * L * C multiply-adds per ray (145 * 73 *
// 18 = 190,530 at full truncation on a 144 x 73 grid), i.e. ~0.4 MFLOP a
// ray, against 12 B of input and 72 B of output: compute and on-chip load
// bound, not device-memory bound. The coefficient matrix (760 KB in
// float32) is shared by every ray and stays L2/L1 resident.
// Design (simple first): one thread per ray, a block of kBlock rays. The
// block builds its basis rows once, in shared memory laid out [mode][ray]
// so a warp's reads are conflict-free; each thread then walks (c, l, m)
// with the coefficient address uniform across the warp (one broadcast load
// serves 32 rays). The latitude reduction runs l = 0..L-1 in order, as the
// Pallas kernel's slice loop does. Under bf16 operands the basis row is
// rounded to bf16 here (the coefficients arrive rounded) and the products
// accumulate in float32, the Pallas kernel's preferred_element_type. The
// m contraction uses explicit fma() (the library builds with -fmad=false).
// Tensor-core (wgmma) tiling of the m contraction is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "ray_rhs.cuh"

namespace {

constexpr int kBlock = 64;

template <typename T, bool kBf16>
__device__ __forceinline__ T round_operand(T x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kBlock)
spectral_kernel(const T* __restrict__ lon, const T* __restrict__ lat,
                const T* __restrict__ tht, const T* __restrict__ coeffs,
                int R, int Mp, int L, int C, T* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  T* blon = reinterpret_cast<T*>(smem_raw);  // [Mp][kBlock]
  T* blat = blon + static_cast<long long>(Mp) * kBlock;  // [L][kBlock]
  const int tid = threadIdx.x;
  const int r = blockIdx.x * kBlock + tid;
  if (r >= R) return;  // each thread reads only its own basis column

  const int M = (Mp - 1) / 2;
  const T lo = lon[r];
  const T th = tht[r];
  blon[tid] = round_operand<T, kBf16>(T(1));
  for (int m = 1; m <= M; ++m) {
    const T ang = lo * T(m);
    blon[m * kBlock + tid] = round_operand<T, kBf16>(cos(ang));
    blon[(M + m) * kBlock + tid] = round_operand<T, kBf16>(sin(ang));
  }
  for (int l = 0; l < L; ++l) blat[l * kBlock + tid] = cos(th * T(l));

  const bool in_range = fabs(lat[r]) <= T(0.5 * rwrt::kPi);
  const long long LC = static_cast<long long>(L) * C;
  for (int c = 0; c < C; ++c) {
    T acc = T(0);
    for (int l = 0; l < L; ++l) {
      const T* col = coeffs + static_cast<long long>(l) * C + c;
      T w = T(0);
      for (int m = 0; m < Mp; ++m) {
        w = fma(blon[m * kBlock + tid], __ldg(col + m * LC), w);
      }
      const T term = blat[l * kBlock + tid] * w;
      acc = (l == 0) ? term : acc + term;
    }
    out[static_cast<long long>(r) * C + c] =
        in_range ? acc : rwrt::nan_value<T>();
  }
}

template <typename T, bool kBf16>
int launch(const T* lon, const T* lat, const T* tht, const T* coeffs, int R,
           int Mp, int L, int C, T* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Mp + L) * kBlock * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_kernel<T, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (R + kBlock - 1) / kBlock;
  spectral_kernel<T, kBf16><<<grid, kBlock, smem, stream>>>(
      lon, lat, tht, coeffs, R, Mp, L, C, out);
  return cudaGetLastError();
}

template <typename T>
int launch_spectral(const void* lon, const void* lat, const void* tht,
                    const void* coeffs, int R, int Mp, int L, int C,
                    int round_bf16, void* out, void* stream) {
  if (R <= 0) return cudaSuccess;
  auto args = [&](auto kernel_launch) {
    return kernel_launch(static_cast<const T*>(lon),
                         static_cast<const T*>(lat),
                         static_cast<const T*>(tht),
                         static_cast<const T*>(coeffs), R, Mp, L, C,
                         static_cast<T*>(out),
                         static_cast<cudaStream_t>(stream));
  };
  if (!round_bf16) return args(launch<T, false>);
  if constexpr (std::is_same<T, float>::value) {
    return args(launch<T, true>);
  } else {
    return cudaErrorInvalidValue;  // bf16 operands take float32 coeffs
  }
}

}  // namespace

extern "C" {

int rwrt_spectral_f32(const void* lon, const void* lat, const void* tht,
                      const void* coeffs, int R, int Mp, int L, int C,
                      int round_bf16, void* out, void* stream) {
  return launch_spectral<float>(lon, lat, tht, coeffs, R, Mp, L, C,
                                round_bf16, out, stream);
}

int rwrt_spectral_f64(const void* lon, const void* lat, const void* tht,
                      const void* coeffs, int R, int Mp, int L, int C,
                      int round_bf16, void* out, void* stream) {
  return launch_spectral<double>(lon, lat, tht, coeffs, R, Mp, L, C,
                                 round_bf16, out, stream);
}

}  // extern "C"
