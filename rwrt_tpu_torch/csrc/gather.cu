// Row gather: out[i, :] = table[idx[i], :].
//
// Replaces (rwrt_tpu): benchmarks/pallas_gather_probe.py pallas_gather (body
// gather_kernel), a probe of whether a kernel beats XLA's row gather for the
// background sample: the table sat whole in VMEM, the indices in SMEM, and a
// fori_loop copied one dynamically addressed row per trip, 2,048 rows per
// grid step. Plain PyTorch version: rwrt_tpu_torch/probes/gather_probe.py
// gather_rows_plain (Tensor.index_select).
//
// What bounds it on an H100: bytes. A pure copy with no arithmetic: per row
// 4 B of index read and w * sizeof(T) B written, and the table read (once,
// if it stays in the 50 MB L2: 2 MB at the probe's width 48, 16 MB at 384).
// Design: the table is left in device memory and read through the read-only
// path, so the L2 holds it; no shared memory (the TPU's VMEM copy has no
// reason here). Every row is a whole number of 16-byte vectors (the width a
// multiple of 4 floats or 2 doubles, the wrapper checks), and one thread
// moves one vector: neighbouring threads take neighbouring vectors of one
// row, so the reads of a row and the writes of the output are coalesced.
// The row's index is read from device memory once: its threads load the
// same word in one transaction. A grid-stride loop covers any row count.
// The indices are not checked, as the Pallas kernel did not check them:
// each must lie in [0, rows of the table).
#include <cuda_runtime.h>

namespace {

// One thread per 16-byte vector of the output, n = R * vecs of them (the
// wrapper keeps n below 2^31); 32-bit index arithmetic, the table offset in
// 64 bits.
__global__ void gather_kernel(const float4* __restrict__ table,
                              const int* __restrict__ idx, int n, int vecs,
                              float4* __restrict__ out) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const int i = k / vecs;
    const int j = k - i * vecs;
    const long long row = __ldg(idx + i);
    out[k] = __ldg(table + row * vecs + j);
  }
}

int launch_gather(const void* table, int row_bytes, const void* idx, int R,
                  void* out, void* stream) {
  if (R <= 0) return cudaSuccess;
  const int vecs = row_bytes / 16;
  const int n = R * vecs;
  const int block = 256;
  // Enough blocks for every vector at this size, at most 32 a multiprocessor
  // of the 132 (the grid-stride loop takes the rest).
  const int want = (n + block - 1) / block;
  const int grid = want < 132 * 32 ? want : 132 * 32;
  gather_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(idx), n,
      vecs, static_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define RWRT_GATHER(SUFFIX, T)                                               \
  int rwrt_gather_##SUFFIX(const void* table, int width, const void* idx,    \
                           int R, void* out, void* stream) {                 \
    return launch_gather(table, width * static_cast<int>(sizeof(T)), idx, R, \
                         out, stream);                                       \
  }

RWRT_GATHER(f32, float)
RWRT_GATHER(f64, double)

#undef RWRT_GATHER

}  // extern "C"
