// The spectral sampler on Hopper's fp8 tensor cores: a measurement probe,
// not part of the package (fp8_mode_probe.py builds and runs it).
//
// The package runs the float8_e4m3fn and float8_e5m2 operand cases over
// float32 coefficients on the bf16 MMA, which is exact for every float8
// value. This file adds a fifth tensor-core format to the package's own
// kernel, rwrt_tpu_torch/csrc/spectral.cu, included whole as
// spectral_fp8.cu (fp8_mode_probe.py writes it with one change: Mode gains
// the enumerators kFp8E4M3 and kFp8E5M2), so the basis, the tile ring, the latitude
// reduction and the rounding are the package's. The format is
// wgmma.mma_async m64n80k32 on e4m3 or e5m2 operands (QGMMA; sm_90a lowers mma.sync's e4m3 and e5m2 shapes to a conversion to f16 and
// HMMAs, so only wgmma reaches the fp8 tensor cores). A warpgroup's 64
// rays times a tile's 80 columns and its whole k depth (32) make one
// instruction: A from registers (mma.m16n8k32's fragment of 8-bit values,
// the warp's 16 rows of the warpgroup's 64), B K-major without swizzle,
// read by the tensor cores from the staged tile, which holds core matrices
// (8 rows of 16 bytes) in [n / 8][k / 16] order in the first 2,560 of its
// 80 x 48 bytes. Each instruction's product starts from a zero accumulator
// and is added into the float32 accumulator on the FMA pipes, since the
// fp8 tensor cores keep only ~14 bits in their sums; within one
// instruction they keep no more, which is what the probe measures against
// the sampler's 1e-5 bar.
#include <cuda_fp8.h>

#include "spectral_fp8.cu"

namespace {

// The two formats beside the package's four, each with its float8 type as
// the operand type (written only by to_op below, bits exact).
template <>
struct Cfg<Mode::kFp8E4M3> {
  using Acc = float;
  using Op = __nv_fp8_e4m3;
  static constexpr int kPlanes = 1, kKStep = 32, kPad = 16, kWN = 1,
                       kMT = 1;
};

template <>
struct Cfg<Mode::kFp8E5M2> : Cfg<Mode::kFp8E4M3> {
  using Op = __nv_fp8_e5m2;
};

// A value already rounded to the format (round_to) as its float8 bits:
// e4m3's NaN is 0x7f; e5m2 keeps inf.
template <>
__device__ __forceinline__ __nv_fp8_e4m3 to_op<__nv_fp8_e4m3, float>(
    float x) {
  __nv_fp8_e4m3 r;
  r.__x = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return r;
}
template <>
__device__ __forceinline__ __nv_fp8_e5m2 to_op<__nv_fp8_e5m2, float>(
    float x) {
  __nv_fp8_e5m2 r;
  r.__x = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E5M2);
  return r;
}

// The wgmma descriptor of the staged B tile: core matrices 128 bytes apart
// along k (the leading byte offset) and 256 apart along n (the stride byte
// offset).
__device__ __forceinline__ uint64_t fp8_b_desc(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a >> 4) & 0x3FFF) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(256 >> 4) << 32);
}

// d = A * B on the fp8 tensor cores from a zero accumulator (scale-d 0);
// the warpgroup waits for the product before it returns.
template <Mode M>
__device__ __forceinline__ void wgmma_fp8(float (&d)[40],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
#define RWRT_WGMMA(TYPES)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n80k32.f32." TYPES " "                \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"  \
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35," \
      "%36,%37,%38,%39}, {%40,%41,%42,%43}, %44, p, 1, 1;\n}\n"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0))
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  if constexpr (M == Mode::kFp8E4M3) {
    RWRT_WGMMA("e4m3.e4m3");
  } else {
    RWRT_WGMMA("e5m2.e5m2");
  }
#undef RWRT_WGMMA
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// One tile's k depth for the warpgroup; the product lands in the places of
// acc that the package's MMAs fill.
template <Mode M>
__device__ __forceinline__ void fp8_step(float (&acc)[1][10][4],
                                         const typename Cfg<M>::Op* a,
                                         int sA,
                                         const typename Cfg<M>::Op* bs,
                                         int k, int t) {
  const auto* a0 = a + k + 4 * t;
  const auto* a1 = a0 + 8 * sA;
  const uint32_t af[4] = {ld32(a0), ld32(a1), ld32(a0 + 16), ld32(a1 + 16)};
  float d[40];
#pragma unroll
  for (int q = 0; q < 40; ++q) d[q] = 0.0f;
  wgmma_fp8<M>(d, af, fp8_b_desc(bs));
#pragma unroll
  for (int j = 0; j < 10; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[0][j][q] += d[4 * j + q];
  }
}

template <>
__device__ __forceinline__ void mma_step<Mode::kFp8E4M3, Fmt::kE4M3, 1, 10>(
    float (&acc)[1][10][4], const __nv_fp8_e4m3* a, int sA,
    const __nv_fp8_e4m3* bs, int, int k, int, int, int t) {
  fp8_step<Mode::kFp8E4M3>(acc, a, sA, bs, k, t);
}

template <>
__device__ __forceinline__ void mma_step<Mode::kFp8E5M2, Fmt::kE5M2, 1, 10>(
    float (&acc)[1][10][4], const __nv_fp8_e5m2* a, int sA,
    const __nv_fp8_e5m2* bs, int, int k, int, int, int t) {
  fp8_step<Mode::kFp8E5M2>(acc, a, sA, bs, k, t);
}

}  // namespace

extern "C" {

// The sampler in the fp8 mode: float32 lon, lat, tht and out; packed: the
// probe's tiles (C, G, Kp / 32, 1, 80, 48) of float8 bytes. fmt: the
// package's case code, 4 (e4m3fn) or 5 (e5m2). Refuses a fit whose block
// would not hold two whole warpgroups.
int fp8_probe_spectral(const void* lon, const void* lat, const void* tht,
                       const void* packed, int R, int Mp, int L, int C,
                       int Kp, int Lp, int fmt, void* out, void* stream) {
  if (smem_bytes<Mode::kFp8E4M3>(kThreads / 32, Kp, Lp) > kMaxSmem) {
    return cudaErrorInvalidConfiguration;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (static_cast<Fmt>(fmt)) {
    case Fmt::kE4M3:
      return launch<Mode::kFp8E4M3, Fmt::kE4M3>(lon, lat, tht, packed, R,
                                                Mp, L, C, Kp, Lp, out, s);
    case Fmt::kE5M2:
      return launch<Mode::kFp8E5M2, Fmt::kE5M2>(lon, lat, tht, packed, R,
                                                Mp, L, C, Kp, Lp, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
