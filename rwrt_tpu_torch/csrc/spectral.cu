// Spectral sampler kernel: evaluate the tensor-product spectral background
//
//   out[r, c] = sum_l cos(l * tht[r]) * sum_m blon[r, m] * coeffs[m, l, c]
//
// with blon[r] = [1, cos(m lon[r]), sin(m lon[r])] (m = 1..M), rows with
// |lat| > pi/2 NaN, the m contraction on the tensor cores.
//
// Replaces (rwrt_tpu): ops/spectral_sample.py:324 sample_spectral_pallas and
// its Pallas body _spectral_kernel. Plain PyTorch version:
// rwrt_tpu_torch/ops/spectral_sample.py sample_spectral.
//
// What bounds it on an H100: 2 * Mp * L * C flops per ray (145 x 73 x 18 at
// full truncation on a 144 x 73 grid, 0.38 MFLOP) against 12 B read and
// 4-8 B x C written: compute, on the tensor cores. The coefficients
// (0.76 MB in float32) are shared by every ray and stay in L2, but every
// block streams all of them through shared memory, so the copies must not
// compete with the MMAs' operand loads; short of the MMA rate, the latency
// of the shared-memory loads that feed each MMA is what is left.
//
// Design. The wrapper repacks the coefficients into tiles (pack_coeffs):
// for each channel, group of 80 latitude columns and chunk of kKC in k, one
// contiguous tile laid out as shared memory holds it, (P, 80, kKC + pad),
// k contiguous so an MMA B fragment is one shared load, zero past Mp and L;
// P = 2 planes (tf32 hi, lo) for float32, else 1. A block owns BM rays. Its
// prologue builds the basis tile A (BM x Kp, direct sincos of m * lon, no
// angle recurrence) and the latitude basis (BM x Lp, zero past L) in shared
// memory once. The main loop walks the tiles through a three-stage ring:
// one thread issues each tile as one bulk (TMA) copy that completes on the
// slot's "full" mbarrier, so the copies take no load/store slots from the
// MMA warps; each warp releases the slot on its "empty" mbarrier when its
// MMAs are done. A warp holds kMT x 16 rays x 80 / kWN columns of the
// product in registers and issues its MMAs with no per-tile guard (columns
// past L are zero). When a channel's k loop ends, the epilogue weights each
// accumulator by its latitude basis value, sums the thread's columns, the
// four lanes of a row (__shfl_xor) and the kWN warps of a row (shared
// memory), in a fixed order: no atomics, no second pass, repeated runs are
// bitwise equal. Row strides are padded so the fragment loads are free of
// bank conflicts. Every case runs 256 threads (fewer only when a wide fit's
// basis leaves shared memory for fewer rays), with the registers of one
// block per SM (__launch_bounds__(256, 1)), so the compiler can load the
// next fragments under the current MMAs.
//
// The operand cases (the Pallas kernel casts the lon basis and the
// coefficients to any matmul_dtype and sums in the coefficients' dtype;
// the wrapper's case code, Fmt below, names the dtype). Each takes an MMA
// whose products of the rounded operands are exact, so the sums are in the
// coefficients' dtype, as in JAX:
//   float32, no rounding: 3xTF32. x = hi + lo with hi = tf32(x), lo =
//     tf32(x - hi) (cvt.rna), acc += lo*hi' + hi*lo' + hi*hi' on
//     mma.m16n8k8 tf32. B arrives split by the wrapper; A is split as its
//     fragment loads.
//   float32 coefficients, bf16 or float8 operands: mma.m16n8k16 bf16 with
//     float32 accumulation (the Pallas kernel's preferred_element_type;
//     every float8 value, subnormals and the fnuz ranges included, is
//     exact in bf16, and a product of two bf16 values is exact in float32).
//   float32 coefficients, float16 operands: one TF32 plane, one product
//     (acc += a*b on mma.m16n8k8 tf32): float16 values, subnormals
//     included, are exact in TF32 and their products in float32.
//   float64, with or without rounding (bf16, float16, float32, float8):
//     mma.m16n8k8 f64 (DMMA; four times the work of m8n8k4 per
//     instruction) on values rounded and held in float64.
// Rounding (round_to): float16 and float8 once, to nearest even at the
// format's precision and least exponent (its subnormals), overflowing to
// inf (float16, e5m2) or NaN (e4m3fn, the fnuz types), and fnuz has no -0;
// bf16 by __float2bfloat16, from float64 through float32 (as torch and JAX
// round it); float32 by the cast. The wrapper rounds the coefficients the
// same way (round_operands); rwrt_spectral_round exposes round_to so the
// two can be held to each other bitwise.
// The library builds with -fmad=false; the epilogue's fusing is explicit
// fma().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_rhs.cuh"

namespace {

constexpr int kKC = 32;              // k depth of one B tile
constexpr int kNG = 10;              // n8 MMA tiles in a column group
constexpr int kGroupCols = 8 * kNG;  // 80 latitude columns
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kBarBytes = 128;       // the ring's mbarriers
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's opt-in maximum

enum class Mode { kBf16, kTf32x3, kTf32, kF64 };

// The operand rounding, by the wrapper's case code (OPERAND_DTYPES).
enum class Fmt { kNone, kBf16, kF16, kF32, kE4M3, kE5M2, kE4M3Fnuz, kE5M2Fnuz };

// Per case: accumulator type (also lon/lat/out), shared-memory operand
// type, B planes, k per MMA, row padding (elements) that makes the
// fragment loads conflict-free (a row stride of 4 mod 8 words, counted in
// 4-byte words for 16- and 32-bit operands and in 8-byte words for
// float64), warps that split a row tile's 80 columns, and 16-ray row tiles
// per warp.
template <Mode M>
struct Cfg;

template <>
struct Cfg<Mode::kBf16> {
  using Acc = float;
  using Op = __nv_bfloat16;
  static constexpr int kPlanes = 1, kKStep = 16, kPad = 8, kWN = 1, kMT = 1;
};

template <>
struct Cfg<Mode::kTf32x3> {
  using Acc = float;
  using Op = float;
  static constexpr int kPlanes = 2, kKStep = 8, kPad = 4, kWN = 2, kMT = 2;
};

template <>
struct Cfg<Mode::kTf32> : Cfg<Mode::kTf32x3> {
  static constexpr int kPlanes = 1;
};

template <>
struct Cfg<Mode::kF64> {
  using Acc = double;
  using Op = double;
  static constexpr int kPlanes = 1, kKStep = 8, kPad = 4, kWN = 2, kMT = 1;
};

// A format rounded to by round_to: significand bits (with the implicit
// one), least normal exponent, largest finite value, overflow to inf (else
// NaN), and whether it has a negative zero.
template <Fmt F>
struct Format;
template <>
struct Format<Fmt::kF16> {
  static constexpr int kP = 11, kEmin = -14;
  static constexpr double kMax = 65504.0;
  static constexpr bool kInf = true, kNegZero = true;
};
template <>
struct Format<Fmt::kE4M3> {
  static constexpr int kP = 4, kEmin = -6;
  static constexpr double kMax = 448.0;
  static constexpr bool kInf = false, kNegZero = true;
};
template <>
struct Format<Fmt::kE5M2> {
  static constexpr int kP = 3, kEmin = -14;
  static constexpr double kMax = 57344.0;
  static constexpr bool kInf = true, kNegZero = true;
};
template <>
struct Format<Fmt::kE4M3Fnuz> {
  static constexpr int kP = 4, kEmin = -7;
  static constexpr double kMax = 240.0;
  static constexpr bool kInf = false, kNegZero = false;
};
template <>
struct Format<Fmt::kE5M2Fnuz> {
  static constexpr int kP = 3, kEmin = -15;
  static constexpr double kMax = 57344.0;
  static constexpr bool kInf = false, kNegZero = false;
};

// x rounded to F, held in T (float or double): exact scalings by powers of
// two around one round-to-nearest-even (rint in the default mode).
template <Fmt F, typename T>
__device__ __forceinline__ T round_to(T x) {
  if constexpr (F == Fmt::kNone) {
    return x;
  } else if constexpr (F == Fmt::kBf16) {
    return static_cast<T>(
        __bfloat162float(__float2bfloat16(static_cast<float>(x))));
  } else if constexpr (F == Fmt::kF32) {
    return static_cast<T>(static_cast<float>(x));
  } else {
    using Q = Format<F>;
    int e;
    if constexpr (sizeof(T) == 4) {
      frexpf(x, &e);  // |x| in [2^(e-1), 2^e)
    } else {
      frexp(x, &e);
    }
    const int q = max(e - 1, Q::kEmin) - (Q::kP - 1);
    T r;
    if constexpr (sizeof(T) == 4) {
      r = ldexpf(rintf(ldexpf(x, -q)), q);
    } else {
      r = ldexp(rint(ldexp(x, -q)), q);
    }
    if (fabs(r) > static_cast<T>(Q::kMax)) {
      r = Q::kInf ? copysign(static_cast<T>(INFINITY), x)
                  : rwrt::nan_value<T>();
    }
    if constexpr (!Q::kNegZero) {
      if (r == static_cast<T>(0)) r = static_cast<T>(0);
    }
    return r;
  }
}

// A rounded basis value into the operand type (exact).
template <typename Op, typename T>
__device__ __forceinline__ Op to_op(T x) {
  if constexpr (sizeof(Op) == 2) {
    return __float2bfloat16(static_cast<float>(x));
  } else {
    return static_cast<Op>(x);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One bulk (TMA) copy of `bytes` contiguous bytes, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// One MMA k step of a warp: kMT row tiles of 16 rays (A rows from `a`, the
// warp's ray g, at column k) times kNT n8 tiles (B rows 8j + g of the
// warp's columns `bs`, at tile column kk). acc[i][j] holds [ray g: cols
// 2t, 2t+1; ray g+8: cols 2t, 2t+1] of row tile i. The m16n8k8 fragments
// (tf32 and f64) hold A (g, t), (g+8, t), (g, t+4), (g+8, t+4) and B
// (t, g), (t+4, g); m16n8k16 bf16 holds pairs of consecutive k.
template <Mode M, int kMT, int kNT>
__device__ __forceinline__ void mma_step(
    typename Cfg<M>::Acc (&acc)[kMT][kNT][4], const typename Cfg<M>::Op* a,
    int sA, const typename Cfg<M>::Op* bs, int sB, int k, int kk, int g,
    int t) {
  if constexpr (M == Mode::kBf16) {
    uint32_t af[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const auto* a0 = a + 16 * i * sA + k + 2 * t;
      const auto* a1 = a0 + 8 * sA;
      af[i][0] = ld32(a0);
      af[i][1] = ld32(a1);
      af[i][2] = ld32(a0 + 8);
      af[i][3] = ld32(a1 + 8);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const auto* b = bs + (8 * j + g) * sB + kk + 2 * t;
      const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
#pragma unroll
      for (int i = 0; i < kMT; ++i) mma_bf16(acc[i][j], af[i], b0, b1);
    }
  } else if constexpr (M == Mode::kTf32x3 || M == Mode::kTf32) {
    // kTf32x3 splits A and reads B's lo plane; kTf32's operands are exact
    // in TF32 (rounded to float16), one product each.
    constexpr bool kSplit = M == Mode::kTf32x3;
    uint32_t hi[kMT][4], lo[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const float* a0 = a + 16 * i * sA + k + t;
      const float* a1 = a0 + 8 * sA;
      const float av[4] = {a0[0], a1[0], a0[4], a1[4]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kSplit) {
          hi[i][q] = tf32_rna(av[q]);
          lo[i][q] = tf32_rna(av[q] - __uint_as_float(hi[i][q]));
        } else {
          hi[i][q] = __float_as_uint(av[q]);
        }
      }
    }
    const float* bl = bs + kGroupCols * sB;  // the lo plane (kTf32x3)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int o = (8 * j + g) * sB + kk + t;
      const uint32_t bh0 = __float_as_uint(bs[o]);
      const uint32_t bh1 = __float_as_uint(bs[o + 4]);
      uint32_t bl0 = 0, bl1 = 0;
      if constexpr (kSplit) {
        bl0 = __float_as_uint(bl[o]);
        bl1 = __float_as_uint(bl[o + 4]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if constexpr (kSplit) {
          mma_tf32(acc[i][j], lo[i], bh0, bh1);
          mma_tf32(acc[i][j], hi[i], bl0, bl1);
        }
        mma_tf32(acc[i][j], hi[i], bh0, bh1);
      }
    }
  } else {
    double af[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const double* a0 = a + 16 * i * sA + k + t;
      const double* a1 = a0 + 8 * sA;
      af[i][0] = a0[0];
      af[i][1] = a1[0];
      af[i][2] = a0[4];
      af[i][3] = a1[4];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const double* b = bs + (8 * j + g) * sB + kk + t;
      const double b0 = b[0], b1 = b[4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) mma_f64(acc[i][j], af[i], b0, b1);
    }
  }
}

// Rays per block for `row_warps` warps down the rays.
template <Mode M>
__host__ __device__ constexpr int block_rays(int row_warps) {
  return row_warps * 16 * Cfg<M>::kMT;
}

template <Mode M>
size_t smem_bytes(int row_warps, int Kp, int Lp) {
  using C = Cfg<M>;
  const size_t bm = block_rays<M>(row_warps);
  return kBarBytes +
         (kStages * C::kPlanes * kGroupCols * (kKC + C::kPad) +
          bm * (Kp + C::kPad)) * sizeof(typename C::Op) +
         bm * ((Lp | 8) + C::kWN) * sizeof(typename C::Acc);
}

template <Mode M, Fmt F>
__global__ void __launch_bounds__(kThreads, 1)
spectral_kernel(const typename Cfg<M>::Acc* __restrict__ lon,
                const typename Cfg<M>::Acc* __restrict__ lat,
                const typename Cfg<M>::Acc* __restrict__ tht,
                const typename Cfg<M>::Op* __restrict__ packed, int R, int Mp,
                int L, int C, int Kp, int Lp,
                typename Cfg<M>::Acc* __restrict__ out) {
  using Acc = typename Cfg<M>::Acc;
  using Op = typename Cfg<M>::Op;
  constexpr int kPlanes = Cfg<M>::kPlanes;
  constexpr int kWN = Cfg<M>::kWN;
  constexpr int kMT = Cfg<M>::kMT;
  constexpr int kNT = kNG / kWN;  // n8 tiles per warp

  const int tid = threadIdx.x;
  const int nwarps = blockDim.x / 32;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWN, wn = warp % kWN;
  const int bm = block_rays<M>(nwarps / kWN);
  const int r0 = blockIdx.x * bm;
  const int sA = Kp + Cfg<M>::kPad;
  const int sB = kKC + Cfg<M>::kPad;
  const int sL = Lp | 8;  // odd multiple of 8: paired epilogue reads
  const int stage = kPlanes * kGroupCols * sB;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [kStages]
  uint64_t* empty = full + kStages;                         // [kStages]
  Op* bst = reinterpret_cast<Op*>(smem_raw + kBarBytes);  // [S][P][80][sB]
  Op* as = bst + kStages * stage;                         // [bm][sA]
  Acc* bl = reinterpret_cast<Acc*>(as + bm * sA);         // [bm][sL]
  Acc* red = bl + bm * sL;                                // [kWN][bm]

  const int nkc = Kp / kKC;
  const int ngrp = (Lp + kGroupCols - 1) / kGroupCols;
  const int ntiles = C * ngrp * nkc;

  // Thread 0 stages tile `tile` (channel, column group, k chunk: the packed
  // order) into its slot once every warp has released the slot's last use.
  auto issue = [&](int tile) {
    if (tid == 0 && tile < ntiles) {
      const int s = tile % kStages;
      if (tile >= kStages) mbar_wait(&empty[s], (tile / kStages - 1) & 1);
      bulk_load(bst + s * stage, packed + static_cast<long long>(tile) * stage,
                stage * sizeof(Op), &full[s]);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nwarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // Prologue (under the first tiles' copies): the block's basis rows. Rows
  // past R sample (0, 0) and are never written.
  const int mh = (Mp - 1) / 2;
  for (int i = warp; i < bm; i += nwarps) {
    const int r = r0 + i;
    const Acc lo = r < R ? lon[r] : Acc(0);
    const Acc th = r < R ? tht[r] : Acc(0);
    Op* arow = as + i * sA;
    for (int m = lane; m <= mh; m += 32) {
      if (m == 0) {
        arow[0] = to_op<Op>(Acc(1));
      } else {
        Acc sn, cs;
        const Acc x = lo * Acc(m);
        if constexpr (F == Fmt::kNone) {
          sincos(x, &sn, &cs);
        } else {
          // cos and sin, the functions the plain version calls (held to
          // PyTorch's bits by pow_parity.py), so that the rounded basis is
          // the plain version's to the bit: one ulp moved across a
          // rounding boundary would move an operand by a whole ulp of the
          // narrow format.
          cs = cos(x);
          sn = sin(x);
        }
        arow[m] = to_op<Op>(round_to<F>(cs));
        arow[mh + m] = to_op<Op>(round_to<F>(sn));
      }
    }
    for (int k = 2 * mh + 1 + lane; k < sA; k += 32) {
      arow[k] = to_op<Op>(Acc(0));
    }
    Acc* lrow = bl + i * sL;
    for (int l = lane; l < sL; l += 32) {
      lrow[l] = l < L ? cos(th * Acc(l)) : Acc(0);
    }
  }
  // The ray this thread writes in the epilogue (threads 0..bm-1).
  const int r_out = r0 + tid;
  const bool writes = tid < bm && r_out < R;
  const bool in_range = writes && fabs(lat[r_out]) <= Acc(0.5 * rwrt::kPi);

  const int wr = wm * 16 * kMT;
  const Op* a = as + (wr + g) * sA;
  const int b_off = wn * kNT * 8 * sB;  // this warp's first B row

  Acc acc[kMT][kNT][4];
  Acc part[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    part[i][0] = part[i][1] = Acc(0);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = Acc(0);
    }
  }

  __syncthreads();  // the basis is written
  for (int tile = 0; tile < ntiles; ++tile) {
    issue(tile + kStages - 1);
    const int s = tile % kStages;
    mbar_wait(&full[s], (tile / kStages) & 1);
    const int kc = tile % nkc;
    const int grp = (tile / nkc) % ngrp;
    const Op* bs = bst + s * stage + b_off;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += Cfg<M>::kKStep) {
      mma_step<M, kMT, kNT>(acc, a, sA, bs, sB, kc * kKC + kk, kk, g, t);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (kc != nkc - 1) continue;

    // Latitude reduction of this column group over its columns below Lp,
    // then clear the accumulators.
    const int j0 = wn * kNT;
    const int nt = min(kNG, (Lp - grp * kGroupCols) / 8) - j0;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const Acc* l0 =
          bl + (wr + 16 * i + g) * sL + grp * kGroupCols + 8 * j0 + 2 * t;
      const Acc* l1 = l0 + 8 * sL;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j < nt) {
          part[i][0] = fma(acc[i][j][0], l0[8 * j], part[i][0]);
          part[i][0] = fma(acc[i][j][1], l0[8 * j + 1], part[i][0]);
          part[i][1] = fma(acc[i][j][2], l1[8 * j], part[i][1]);
          part[i][1] = fma(acc[i][j][3], l1[8 * j + 1], part[i][1]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = Acc(0);
      }
    }
    if (grp != ngrp - 1) continue;

    // Channel done: sum the quad, then the kWN warps of each ray.
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Acc v = part[i][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red[wn * bm + wr + 16 * i + 8 * h + g] = v;
        part[i][h] = Acc(0);
      }
    }
    __syncthreads();
    if (writes) {
      Acc v = red[tid];
#pragma unroll
      for (int w = 1; w < kWN; ++w) v += red[w * bm + tid];
      const int c = tile / (nkc * ngrp);
      out[static_cast<long long>(r_out) * C + c] =
          in_range ? v : rwrt::nan_value<Acc>();
    }
    __syncthreads();  // red is read before the next channel writes it
  }
}

template <Mode M, Fmt F>
int launch(const void* lon, const void* lat, const void* tht,
           const void* packed, int R, int Mp, int L, int C, int Kp, int Lp,
           void* out, cudaStream_t stream) {
  using Acc = typename Cfg<M>::Acc;
  using Op = typename Cfg<M>::Op;
  if (Mp < 1 || L < 1 || C < 1 || Kp < Mp || Kp % kKC != 0 || Lp < L ||
      Lp % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  if (R <= 0) return cudaSuccess;
  // As many rays per block as shared memory allows (A and the latitude
  // basis grow with them); fewer warps below 256 threads on wide fits.
  int row_warps = kThreads / (32 * Cfg<M>::kWN);
  while (row_warps > 1 && smem_bytes<M>(row_warps, Kp, Lp) > kMaxSmem) {
    row_warps /= 2;
  }
  const size_t smem = smem_bytes<M>(row_warps, Kp, Lp);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      spectral_kernel<M, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int bm = block_rays<M>(row_warps);
  const int grid = (R + bm - 1) / bm;
  spectral_kernel<M, F><<<grid, row_warps * Cfg<M>::kWN * 32, smem, stream>>>(
      static_cast<const Acc*>(lon), static_cast<const Acc*>(lat),
      static_cast<const Acc*>(tht), static_cast<const Op*>(packed), R, Mp, L,
      C, Kp, Lp, static_cast<Acc*>(out));
  return cudaGetLastError();
}

template <Fmt F, typename T>
__global__ void round_kernel(const T* __restrict__ x, long long n,
                             T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = round_to<F>(x[i]);
  }
}

template <Fmt F, typename T>
int launch_round(const void* x, long long n, void* out, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n + 255) / 256;
  round_kernel<F, T><<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256,
                       0, s>>>(static_cast<const T*>(x), n,
                               static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
int round_case(const void* x, long long n, int fmt, void* out,
               cudaStream_t s) {
  switch (static_cast<Fmt>(fmt)) {
    case Fmt::kNone: return launch_round<Fmt::kNone, T>(x, n, out, s);
    case Fmt::kBf16: return launch_round<Fmt::kBf16, T>(x, n, out, s);
    case Fmt::kF16: return launch_round<Fmt::kF16, T>(x, n, out, s);
    case Fmt::kF32: return launch_round<Fmt::kF32, T>(x, n, out, s);
    case Fmt::kE4M3: return launch_round<Fmt::kE4M3, T>(x, n, out, s);
    case Fmt::kE5M2: return launch_round<Fmt::kE5M2, T>(x, n, out, s);
    case Fmt::kE4M3Fnuz:
      return launch_round<Fmt::kE4M3Fnuz, T>(x, n, out, s);
    case Fmt::kE5M2Fnuz:
      return launch_round<Fmt::kE5M2Fnuz, T>(x, n, out, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// packed: pack_coeffs tiles: float32 (hi, lo) for case 0 (no rounding),
// one float32 plane of float16 values for case 2, one bfloat16 plane for
// case 1 (bf16) and cases 4-7 (float8); case 3 (float32) is case 0's.
int rwrt_spectral_f32(const void* lon, const void* lat, const void* tht,
                      const void* packed, int R, int Mp, int L, int C, int Kp,
                      int Lp, int fmt, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define RWRT_SPECTRAL(MODE, FMT) \
  launch<Mode::MODE, Fmt::FMT>(lon, lat, tht, packed, R, Mp, L, C, Kp, Lp, \
                               out, s)
  switch (static_cast<Fmt>(fmt)) {
    case Fmt::kNone:
    case Fmt::kF32: return RWRT_SPECTRAL(kTf32x3, kNone);
    case Fmt::kBf16: return RWRT_SPECTRAL(kBf16, kBf16);
    case Fmt::kF16: return RWRT_SPECTRAL(kTf32, kF16);
    case Fmt::kE4M3: return RWRT_SPECTRAL(kBf16, kE4M3);
    case Fmt::kE5M2: return RWRT_SPECTRAL(kBf16, kE5M2);
    case Fmt::kE4M3Fnuz: return RWRT_SPECTRAL(kBf16, kE4M3Fnuz);
    case Fmt::kE5M2Fnuz: return RWRT_SPECTRAL(kBf16, kE5M2Fnuz);
  }
  return cudaErrorInvalidValue;
}

// packed: pack_coeffs tiles, float64, the values rounded to case `fmt`.
int rwrt_spectral_f64(const void* lon, const void* lat, const void* tht,
                      const void* packed, int R, int Mp, int L, int C, int Kp,
                      int Lp, int fmt, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (static_cast<Fmt>(fmt)) {
    case Fmt::kNone: return RWRT_SPECTRAL(kF64, kNone);
    case Fmt::kBf16: return RWRT_SPECTRAL(kF64, kBf16);
    case Fmt::kF16: return RWRT_SPECTRAL(kF64, kF16);
    case Fmt::kF32: return RWRT_SPECTRAL(kF64, kF32);
    case Fmt::kE4M3: return RWRT_SPECTRAL(kF64, kE4M3);
    case Fmt::kE5M2: return RWRT_SPECTRAL(kF64, kE5M2);
    case Fmt::kE4M3Fnuz: return RWRT_SPECTRAL(kF64, kE4M3Fnuz);
    case Fmt::kE5M2Fnuz: return RWRT_SPECTRAL(kF64, kE5M2Fnuz);
  }
#undef RWRT_SPECTRAL
  return cudaErrorInvalidValue;
}

// The kernel's operand rounding (round_to) of n values, case `fmt`: held
// to round_operands bitwise by chip_smoke; not on any run path.
int rwrt_spectral_round_f32(const void* x, long long n, int fmt, void* out,
                            void* stream) {
  return round_case<float>(x, n, fmt, out, static_cast<cudaStream_t>(stream));
}

int rwrt_spectral_round_f64(const void* x, long long n, int fmt, void* out,
                            void* stream) {
  return round_case<double>(x, n, fmt, out,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
