// The ray RHS and the termination physics for one lane, as __device__
// functions shared by the RHS kernel (rhs.cu), the dense kernels
// (dense_run.cu), the RK4 kernel (rk4_run.cu) and the exact kernels
// (exact_run.cu).
//
// Replaces (rwrt_tpu, fused by XLA there, no Pallas original):
//   ops/interp.py       _packed_cell, _packed_corner_lerp (one packed row),
//                       mercator_transform on the 12 hot fields
//   ops/groupvel.py     group_velocity_core
//   models/ray.py       _rhs_core (tendencies, err flag, per-row NaN sets),
//                       group_velocity_at, haversine, kill_mask
// and the plain PyTorch versions beside them in rwrt_tpu_torch/models/ray.py,
// whose expressions and operation order this file follows.
//
// What bounds it on an H100: one 48-value row (192 B in float32) gathered
// per lane per call from a ~2 MB packed background that every lane shares,
// plus ~150 flops and a sin/cos pair. The background fits the 50 MB L2
// many times over, so the gather is an L2 hit after warm-up. The
// dependent chain of one evaluation holds the kernels at every lane count
// (~1 us in float32 for a lone lane: fmod, divisions, the gather, the
// lerps, the Mercator and tendency divisions); contention between lanes
// only stretches it, 3.4x at 60,784 lanes. A warp-staged gather, which
// cut the global wavefronts of a warp's evaluation from 384 to ~70
// through a shared-memory tile, lengthened the chain 2.7x and ran
// 1.5-2.2x slower at full launches (PERF.md).
//
// Design. Every NaN rule is an explicit mask (never IEEE propagation), as
// in the plain version, so kx = 0 or infinite inputs give the same NaN
// pattern. The sample-independent terms (the latitude's sin and cos, the
// wavenumber ratios, divided beside the cell) are computed before the
// gather so that they may overlap its latency, and floor_mod skips fmod
// where it is the identity. How a lane's evaluation spreads over threads is the
// kernel's INSTANCE, a template argument of every function that samples
// the background:
//   Lane      one thread per lane: the row by 12 (float32) or 24 (float64)
//             16-byte loads of its own, and the evaluation's 14-17 IEEE
//             divisions one after another. The dense and RHS kernels, and
//             the RK4 and exact kernels where the lanes fill the card or
//             are few.
//   Split     8 threads per lane, an aligned group of a warp: six owner
//             threads each load and lerp 2 of the 12 fields (8-byte or
//             16-byte loads); the evaluation's IEEE divisions run in three
//             groups, each division of a group on its own thread, one
//             division instruction for the warp: the cell's two beside the
//             wavenumber ratios (kap, and a raw group velocity's), the
//             Mercator transform's four beside tan(lat), and those of
//             group velocity and the tendencies (6) and of a raw group
//             velocity (2); shuffles give every thread of the team all
//             fields and all quotients. Everything else runs
//             identically in every thread of the team, so the team never
//             diverges and the state needs no broadcast. For launches of
//             some dozens to a few thousand lanes, where it shortens the
//             chain by the divisions' latency and spreads the lanes over
//             the idle SMs. In a warp the threads of different roles run
//             one after another, so a split that gave each thread its own
//             expression would not shorten the chain: the split is by
//             operands, not by code. Teams that shared only the loads and
//             lerps (of 4 and of 8 threads) lost to Split (PERF.md).
// Each field and each quotient is computed by one thread with the same
// expression in every instance, so all instances give the same bits.
//
// Time-varying and ensemble backgrounds (the TIME instances, a
// compile-time flag of the background type, Background<F, true>; compiled
// in the *_time.cu units, so the static instances' code is the one-type
// code above). The stack is (nt, W, H, 48) frames a member, members at a
// stride of nt * W * H * 48 values. A lane's member offset is folded into
// its base pointer once, when the lane starts (lane_background, 64-bit:
// eight members of 91 daily frames on the 145 x 73 grid are ~1.5 GB). A
// timed sample reads the lane's cell in the two frames bracketing its time
// (lerp_frames) and blends the two lerped rows, as interp.py's
// sample_raw_packed_time does, before the Mercator transform; an untimed
// one (an ensemble of static members) reads frame 0 alone. Every sampling
// function takes the lane's time t: the RHS in F (the JAX package rounds
// a mixed state's time to the background's type at entry, as its state),
// group_velocity_at in the state's type. The static instances never read
// it.
//
// Mixed precision (a float64 state S over a float32 background F, the JAX
// package's state_dtype='float64'): the RHS takes its state rounded to F
// by the caller, as the JAX package casts it at entry, and runs in F
// throughout. The diagnostic (ug, vg) of a saved state does not round it:
// sample_mercator and group_velocity_at are templated on (S, F), reading
// the F corners and computing the cell, the lerp, the Mercator transform
// and group velocity in S, where JAX's promotion puts them. With S == F
// every cast below is the identity, and the code is the one-type code.
//
// Semantics kept (see models/ray.py _rhs_core):
//   - (lon - lon0) mod 2*pi is a FLOOR mod (fmod truncates; fixed below);
//   - the cell index is floor() clipped to [0, W-1] x [0, H-1] with NaN
//     going to 0, and (sx, sy) come from the clipped cell;
//   - live = !(|cos(lat)| <= polar_cos_cap), so a NaN latitude stays live;
//     fmuy = fuy + tan(lat) fu without a division by cos; fmqxy and fmqyx
//     both come from the smoothed qxy sample (packed channel 9);
//   - dead lanes sample cell (0, 0), bad lanes compute with kx = 1, ky = 0,
//     and the row NaN sets r0n..r4n are applied last; a NaN amp poisons
//     row 4 only.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rwrt {

constexpr double kPi = 3.14159265358979323846264338327950288419716939937510;
constexpr double kRearth = 6.3712e6;
constexpr double kPolarCosCap = 0.0175;
constexpr double kMwnCap = 100.0;
constexpr int kHot = 12;
constexpr int kPacked = 4 * kHot;
// Threads per block of every integrator kernel.
constexpr int kBlock = 128;

template <typename T, bool kTime = false>
struct Background {
  const T* packed;  // (W, H, 48): [F(w,h), F(w+1,h), F(w,h+1), F(w+1,h+1)]
  int W;
  int H;
  T lon0, lat0, dx, dy;
};

// A time-varying or ensemble background (see the head of this file).
template <typename T>
struct Background<T, true> {
  const T* packed;  // member 0's frame 0; a lane's after lane_background
  int W;
  int H;
  T lon0, lat0, dx, dy;
  int nt;             // frames a member
  bool timed;         // lerp in time; else frame 0 alone
  T t0, tdt;          // model time of frame 0, frame spacing
  const int* member;  // (R,) lane -> member, or null
  __host__ __device__ long long frame() const {
    return static_cast<long long>(W) * H * kPacked;
  }
};

// The background of an entry point's arguments: static, or with the time
// instances' (nt, timed, t0, dt, member).
template <typename T>
Background<T, false> make_background(const void* packed, int W, int H,
                                     double lon0, double lat0, double dx,
                                     double dy) {
  return Background<T, false>{static_cast<const T*>(packed), W, H, T(lon0),
                              T(lat0), T(dx), T(dy)};
}

template <typename T>
Background<T, true> make_background(const void* packed, int W, int H,
                                    double lon0, double lat0, double dx,
                                    double dy, int nt, int timed, double t0,
                                    double tdt, const void* member) {
  return Background<T, true>{static_cast<const T*>(packed), W, H, T(lon0),
                             T(lat0), T(dx), T(dy), nt, timed != 0, T(t0),
                             T(tdt), static_cast<const int*>(member)};
}

// Lane i's background: the static one as it is; a time instance's with
// the lane's member offset folded into its base pointer.
template <typename T>
__device__ __forceinline__ const Background<T, false>& lane_background(
    const Background<T, false>& bg, int) {
  return bg;
}

template <typename T>
__device__ __forceinline__ Background<T, true> lane_background(
    const Background<T, true>& bg, int i) {
  Background<T, true> b = bg;
  if (bg.member != nullptr) {
    b.packed += static_cast<long long>(__ldg(bg.member + i)) * bg.nt *
                bg.frame();
  }
  return b;
}

template <typename T>
__device__ __forceinline__ T nan_value() {
  return static_cast<T>(NAN);
}

// Floor mod with the divisor's sign, as jnp/torch remainder, for m > 0.
// Inside (-m, m) fmod(x, m) is x exactly, so its loop is skipped there;
// x = -m is left to fmod, which returns -0 for it.
template <typename T>
__device__ __forceinline__ T floor_mod(T x, T m) {
  T r;
  if (x > -m && x < m) {
    r = x;
  } else {
    r = fmod(x, m);
  }
  if (r != T(0) && ((r < T(0)) != (m < T(0)))) r += m;
  return r;
}

// floor(x) clipped to [0, n - 1]; NaN goes to 0.
template <typename T>
__device__ __forceinline__ int cell_index(T x, int n) {
  T f = floor(x);
  if (!(f >= T(0))) return 0;
  if (f > T(n - 1)) return n - 1;
  return static_cast<int>(f);
}

// N values from p by 16-byte loads (8-byte ones for two floats) through the
// read-only path; p is aligned to the load's width.
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, T* out) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
      out[4 * q] = x.x;
      out[4 * q + 1] = x.y;
      out[4 * q + 2] = x.z;
      out[4 * q + 3] = x.w;
    }
  } else if constexpr (sizeof(T) == 4) {
    static_assert(N % 2 == 0, "pairs of floats");
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p) + q);
      out[2 * q] = x.x;
      out[2 * q + 1] = x.y;
    }
  } else {
    static_assert(N % 2 == 0, "pairs of doubles");
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const double2 x = __ldg(reinterpret_cast<const double2*>(p) + q);
      out[2 * q] = x.x;
      out[2 * q + 1] = x.y;
    }
  }
}

// The bilinear blend of one field from its corners (x0,y0), (x1,y0),
// (x0,y1), (x1,y1), with w = {wa, wb, wc, wd}: fa wa + fb wb + fc wc + fd wd
// in that order, fa the (x0,y1) corner. Corners of the background's type F
// are widened to the weights' type S first.
template <typename S, typename F>
__device__ __forceinline__ S lerp4(F c00, F c10, F c01, F c11,
                                   const S w[4]) {
  return S(c01) * w[0] + S(c11) * w[1] + S(c00) * w[2] + S(c10) * w[3];
}

// ---- Instances: the lane's row (type F) to its 12 lerped fields (type
// S), and the IEEE divisions of an evaluation (divide: q[j] = num[j] /
// den[j]). ----

struct Lane {
  static constexpr int kThreads = 1;
  static constexpr int kId = 0;
  // tan(lat)'s division ahead of the gather, where it overlaps the row's
  // loads: the lane's divisions run one after another, so beside the
  // Mercator transform's it would lengthen the chain (PERF.md section 6).
  static constexpr bool kTanAhead = true;
  static __device__ __forceinline__ bool lead() { return true; }
  // A branch decision the lane's threads take as one: its own.
  static __device__ __forceinline__ bool uniform(bool x) { return x; }
  template <typename S, typename F>
  static __device__ __forceinline__ void lerp_row(const F* packed, int cell,
                                                  const S w[4],
                                                  S raw[kHot]) {
    F rv[kPacked];
    load_vals<F, kPacked>(packed + static_cast<long long>(cell) * kPacked, rv);
#pragma unroll
    for (int c = 0; c < kHot; ++c) {
      raw[c] = lerp4(rv[c], rv[kHot + c], rv[2 * kHot + c], rv[3 * kHot + c],
                     w);
    }
  }
  template <typename T, int N>
  static __device__ __forceinline__ void divide(const T num[N],
                                                const T den[N], T q[N]) {
#pragma unroll
    for (int j = 0; j < N; ++j) q[j] = num[j] / den[j];
  }
};

// 8 threads a lane (see the head of this file).
struct Split {
  static constexpr int kThreads = 8;
  static constexpr int kId = 8;
  // tan(lat)'s division beside the Mercator transform's: one wait fewer.
  static constexpr bool kTanAhead = false;
  // Owner threads and the fields each lerps: 6 x 2.
  static constexpr int kOwners = 6;
  static constexpr int kPer = kHot / kOwners;
  static __device__ __forceinline__ int rank() {
    return threadIdx.x & (kThreads - 1);
  }
  static __device__ __forceinline__ bool lead() { return rank() == 0; }
  // The shuffle mask of this thread's team.
  static __device__ __forceinline__ unsigned mask() {
    return 0xffu << ((threadIdx.x & 31) & ~(kThreads - 1));
  }
  // A branch decision the team takes as one: its first thread's.
  static __device__ __forceinline__ bool uniform(bool x) {
    return __shfl_sync(mask(), int(x), 0, kThreads) != 0;
  }
  // a[j] for this thread's rank j (threads past N take a[0]), by selects:
  // compile-time indices only, so a stays in registers.
  template <typename T, int N>
  static __device__ __forceinline__ T own(const T a[N]) {
    const int t = rank();
    T x = a[0];
#pragma unroll
    for (int j = 1; j < N; ++j) {
      if (t == j) x = a[j];
    }
    return x;
  }
  // out[j] = x of the team's thread j, for j < N, in every thread.
  template <typename T, int N>
  static __device__ __forceinline__ void share(T x, T out[N]) {
    const unsigned team = mask();
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = __shfl_sync(team, x, j, kThreads);
  }
  template <typename S, typename F>
  static __device__ __forceinline__ void lerp_row(const F* packed, int cell,
                                                  const S w[4],
                                                  S raw[kHot]) {
    const int t = rank();
    const unsigned team = mask();
    // A thread past the owners repeats owner 0's loads (the same
    // addresses, so no extra traffic) and lerps nothing anyone reads.
    const int o = t < kOwners ? t : 0;
    const F* row = packed + static_cast<long long>(cell) * kPacked + o * kPer;
    F cv[4][kPer];
#pragma unroll
    for (int k = 0; k < 4; ++k) load_vals<F, kPer>(row + k * kHot, cv[k]);
    S mine[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      mine[c] = lerp4(cv[0][c], cv[1][c], cv[2][c], cv[3][c], w);
    }
#pragma unroll
    for (int s = 0; s < kOwners; ++s) {
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        raw[s * kPer + c] = __shfl_sync(team, mine[c], s, kThreads);
      }
    }
  }
  // Thread j of the team divides num[j] by den[j] (one division
  // instruction for the whole warp, each thread on its own operands; the
  // threads past N repeat j = 0's) and shuffles give every thread all N
  // quotients.
  template <typename T, int N>
  static __device__ __forceinline__ void divide(const T num[N],
                                                const T den[N], T q[N]) {
    static_assert(N <= kThreads, "one division a thread");
    const int t = rank();
    T n = num[0], d = den[0];
#pragma unroll
    for (int j = 1; j < N; ++j) {
      if (t == j) {
        n = num[j];
        d = den[j];
      }
    }
    const T mine = n / d;
    const unsigned team = mask();
#pragma unroll
    for (int j = 0; j < N; ++j) q[j] = __shfl_sync(team, mine, j, kThreads);
  }
};

// f(I{}) for the instance I whose kId is inst; an unknown id is refused.
template <typename F>
int with_instance(int inst, F&& f) {
  switch (inst) {
    case Lane::kId:
      return f(Lane{});
    case Split::kId:
      return f(Split{});
  }
  return cudaErrorInvalidValue;
}

// Threads of `kernel` (blocks of kBlock) the current card keeps resident at
// once: blocks per SM x SMs x kBlock.
template <typename F>
int resident_threads(F* kernel, int* out) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBlock,
                                                      0);
  }
  *out = blocks * sms * kBlock;
  return e;
}

// Launch `kernel` over R lanes as instance I on `stream`.
template <class I, typename F, typename A>
int launch_as(F* kernel, const A& args, int R, cudaStream_t stream) {
  const long long threads = static_cast<long long>(R) * I::kThreads;
  const int grid = static_cast<int>((threads + kBlock - 1) / kBlock);
  kernel<<<grid, kBlock, 0, stream>>>(args);
  return cudaGetLastError();
}

// Group velocity (groupvel.py core) on sanitized (NaN-free) inputs is
// ug = fu + nu / denom, vg = fv + nv / denom, from the wavenumber terms
// kap = mwn / zwn, kap2 and denom = zwn^2 kap1^2; these are the numerators.
template <typename T>
__device__ __forceinline__ void group_velocity_nums(T fqx, T fqy, T kap,
                                                    T kap2, T* nu, T* nv) {
  *nu = (T(1) - kap2) * fqy - T(2) * kap * fqx;
  *nv = T(2) * kap * fqy + (T(1) - kap2) * fqx;
}

// The wavenumber terms of group_velocity on a raw (kx, ky): NaN-free
// substitutes (kx -> 1, ky -> 0) and the two NaN flags. They do not need
// the sample.
template <typename T>
struct GvTerms {
  T kap, kap2, denom;
  bool nk, nm;
};

// The operands of their one division, kap = mwn / zwn (the caller makes
// it beside the sample's cell's: cell_operands), ...
template <typename T>
__device__ __forceinline__ void gv_ratio(T kx, T ky, T* mwn, T* zwn) {
  *zwn = isnan(kx) ? T(1) : kx;
  *mwn = isnan(ky) ? T(0) : ky;
}

// ... and the terms from its quotient.
template <typename T>
__device__ __forceinline__ GvTerms<T> gv_terms(T kx, T ky, T kap) {
  GvTerms<T> g;
  g.nk = isnan(kx);
  g.nm = isnan(ky);
  const T zwn = g.nk ? T(1) : kx;
  g.kap = kap;
  g.kap2 = g.kap * g.kap;
  const T kap1 = T(1) + g.kap2;
  g.denom = zwn * zwn * kap1 * kap1;
  return g;
}

// group_velocity's IEEE-propagation masks on the clean (gu, gv) of a raw
// sample (NaN flags fn): ug NaN with fu, qx, qy, kx, ky; vg with fv, qx,
// qy, kx, ky; both with `dead`.
template <typename T>
__device__ __forceinline__ void group_velocity_masks(const bool fn[kHot],
                                                     const GvTerms<T>& g,
                                                     bool dead, T gu, T gv,
                                                     T* ug, T* vg) {
  const bool shared = fn[6] || fn[7] || g.nk || g.nm;
  *ug = (dead || fn[0] || shared) ? nan_value<T>() : gu;
  *vg = (dead || fn[1] || shared) ? nan_value<T>() : gv;
}

// The time lerp of a timed sample (interp.py sample_raw_packed_time):
// tfrac = (t - t0) / dt held to [0, nt - 1] (NaN stays NaN), the frames
// i0 = floor(tfrac) held the same way (NaN goes to 0) and i1 = min(i0 + 1,
// nt - 1), each row lerped in space with the weights w, then frame(i0) *
// (1 - w1) + frame(i1) * w1 with w1 = tfrac - i0, in T.
template <typename T, typename F, class I>
__device__ __forceinline__ void lerp_frames(const Background<F, true>& bg,
                                            int cell, const T w[4], T t,
                                            T raw[kHot]) {
  T tf = (t - T(bg.t0)) / T(bg.tdt);
  const T last = T(bg.nt - 1);
  if (tf < T(0)) tf = T(0);
  if (tf > last) tf = last;
  const int i0 = cell_index(tf, bg.nt);
  const int i1 = i0 + 1 < bg.nt ? i0 + 1 : bg.nt - 1;
  const T w1 = tf - T(i0);
  const T w0 = T(1) - w1;
  T r0[kHot], r1[kHot];
  I::template lerp_row<T, F>(bg.packed + i0 * bg.frame(), cell, w, r0);
  I::template lerp_row<T, F>(bg.packed + i1 * bg.frame(), cell, w, r1);
#pragma unroll
  for (int c = 0; c < kHot; ++c) raw[c] = r0[c] * w0 + r1[c] * w1;
}

// The operands of a sample's two cell divisions at a (sanitized) position
// of type T: ix = num[0] / den[0], iy = num[1] / den[1]. The caller
// divides them with its own that need no sample, as one group (one
// division wait in a team), and passes the quotients to sample_mercator.
template <typename T, typename F, bool kTime>
__device__ __forceinline__ void cell_operands(const Background<F, kTime>& bg,
                                              T lon, T lat, T num[2],
                                              T den[2]) {
  num[0] = floor_mod(lon - T(bg.lon0), T(2.0 * kPi));
  den[0] = T(bg.dx);
  num[1] = lat - T(bg.lat0);
  den[1] = T(bg.dy);
}

// Mercator sample of the 12 hot fields at the cell coordinates (ix, iy)
// of a (sanitized) position of type T and its latitude, at time t, over a
// background of type F (T = F in the RHS; T = S for a saved state's (ug,
// vg), where the grid scalars and the corners widen to T). f[] receives
// the M_* fields, fn[] their NaN flags; cos/sin of lat are returned for
// reuse.
template <typename T, typename F, class I = Lane, bool kTime = false>
__device__ __forceinline__ void sample_mercator(
    const Background<F, kTime>& bg, T ix, T iy, T lat, T t, T f[kHot],
    bool fn[kHot], T* cos_out, T* sin_out) {
  int x0 = cell_index(ix, bg.W);
  int y0 = cell_index(iy, bg.H);
  T sx = ix - T(x0);
  T sy = iy - T(y0);
  // The latitude terms do not need the sample: ahead of the gather.
  T sin_phi, cos_phi;
  sincos(lat, &sin_phi, &cos_phi);
  bool live = !(fabs(cos_phi) <= T(kPolarCosCap));
  T cosm = live ? cos_phi : T(1e-6);
  T tan_phi = T(0);
  if constexpr (I::kTanAhead) tan_phi = sin_phi / cosm;
  const T w[4] = {(T(1) - sx) * sy, sx * sy, (T(1) - sx) * (T(1) - sy),
                  sx * (T(1) - sy)};
  T raw[kHot];
  if constexpr (kTime) {
    if (bg.timed) {
      lerp_frames<T, F, I>(bg, x0 * bg.H + y0, w, t, raw);
    } else {
      I::template lerp_row<T, F>(bg.packed, x0 * bg.H + y0, w, raw);
    }
  } else {
    I::template lerp_row<T, F>(bg.packed, x0 * bg.H + y0, w, raw);
  }
  bool in_range = fabs(lat) <= T(0.5 * kPi);
#pragma unroll
  for (int c = 0; c < kHot; ++c) {
    if (!in_range) raw[c] = nan_value<T>();
  }

  // Field order: u v ux uy vx vy qx qy qxx qxy qyx qyy. The transform's
  // four divisions as one group, with tan(lat)'s unless it went ahead.
  const T num[5] = {raw[0], raw[1], raw[2], raw[4], sin_phi};
  const T den[5] = {cosm, cosm, cosm, cosm, cosm};
  T q[5];
  I::template divide<T, I::kTanAhead ? 4 : 5>(num, den, q);
  if constexpr (!I::kTanAhead) tan_phi = q[4];
  T fmqyx = raw[9] * cosm;
  f[0] = q[0];
  f[1] = q[1];
  f[2] = q[2];
  f[3] = raw[3] + tan_phi * raw[0];
  f[4] = q[3];
  f[5] = raw[5] + tan_phi * raw[1];
  f[6] = raw[6];
  f[7] = raw[7] * cosm;
  f[8] = raw[8];
  f[9] = fmqyx;
  f[10] = fmqyx;
  f[11] = (raw[11] * cosm - raw[7] * sin_phi) * cosm;
#pragma unroll
  for (int c = 0; c < kHot; ++c) {
    if (!live) f[c] = T(0);
    fn[c] = isnan(f[c]);
  }
  *cos_out = cos_phi;
  *sin_out = sin_phi;
}

// dy/dt of one lane at time t. Writes dy[5] and the err flag; with kGv
// also the raw-(kx, ky) group velocity of the evaluated state
// (rhs_and_gv) to ug_raw, vg_raw.
template <typename T, class I, bool kGv, bool kTime>
__device__ __forceinline__ void rhs_core(const Background<T, kTime>& bg,
                                         const T y[5], T t, T dy[5],
                                         bool* err_out, T* ug_raw,
                                         T* vg_raw) {
  const T lon = y[0], lat = y[1], kx = y[2], ky = y[3], amp = y[4];
  const bool err =
      (fabs(lat) >= T(0.5 * kPi)) || (fabs(ky) >= T(kMwnCap));
  const bool dead = isnan(lon) || isnan(lat) || isnan(kx) || isnan(ky);
  const bool ampn = isnan(amp);
  const bool bad = err || dead;
  const T lon_q = dead ? T(0) : lon;
  const T lat_q = dead ? T(0) : lat;
  const T kx_q = bad ? T(1) : kx;
  const T ky_q = bad ? T(0) : ky;
  const T amp_q = ampn ? T(0) : amp;

  // The divisions that need no sample, as one group: kap, (kGv) the raw
  // group velocity's, and the sample's cell; the wavenumber terms from
  // them ahead of the gather.
  constexpr int N0 = kGv ? 4 : 3;
  T num0[N0], den0[N0], q0[N0];
  num0[0] = ky_q;
  den0[0] = kx_q;
  if constexpr (kGv) gv_ratio(kx, ky, &num0[1], &den0[1]);
  cell_operands(bg, lon_q, lat_q, &num0[N0 - 2], &den0[N0 - 2]);
  I::template divide<T, N0>(num0, den0, q0);
  const T kap = q0[0];
  const T kap2 = kap * kap;
  const T kap1 = T(1) + kap2;
  const T kk = kx_q * kx_q * kap1;
  const T denom = kx_q * kx_q * kap1 * kap1;
  GvTerms<T> g{};
  if constexpr (kGv) g = gv_terms(kx, ky, q0[1]);

  T f[kHot];
  bool fn[kHot];
  T cos_q, sin_q;
  sample_mercator<T, T, I>(bg, q0[N0 - 2], q0[N0 - 1], lat_q, t, f, fn,
                           &cos_q, &sin_q);
  T fq[kHot];
#pragma unroll
  for (int c = 0; c < kHot; ++c) fq[c] = fn[c] ? T(0) : f[c];
  const T fmu = fq[0], fmv = fq[1], fmux = fq[2], fmuy = fq[3];
  const T fmvx = fq[4], fmvy = fq[5], fmqx = fq[6], fmqy = fq[7];
  const T fmqxx = fq[8], fmqxy = fq[9], fmqyx = fq[10], fmqyy = fq[11];

  // The divisions of group velocity and the tendencies (and of the raw
  // group velocity), side by side in a split team.
  constexpr int N = kGv ? 8 : 6;
  T num[N], den[N], q[N];
  group_velocity_nums(fmqx, fmqy, kap, kap2, &num[0], &num[1]);
  den[0] = den[1] = denom;
  num[2] = kap * fmqxx - fmqyx;
  num[3] = kap * fmqxy - fmqyy;
  den[2] = den[3] = kk;
  num[4] = T(2) * (fmux + fmvy + kap * (fmvx + fmuy));
  den[4] = kap1;
  num[5] = T(2) * (kap * (fmqxx - fmqyy) + (kap2 - T(1)) * fmqxy);
  den[5] = kk * kap1;
  if constexpr (kGv) {
    group_velocity_nums(fmqx, fmqy, g.kap, g.kap2, &num[6], &num[7]);
    den[6] = den[7] = g.denom;
  }
  I::template divide<T, N>(num, den, q);

  const T ug = fmu + q[0];
  const T vg = fmv + q[1];
  const T dzwn = -kx_q * ((fmux + kap * fmvx) + q[2]);
  const T dmwn = -kx_q * ((fmuy + kap * fmvy) + q[3]);
  const T damp1 = q[4];
  const T damp2 = q[5];
  const T damp3 = T(-2) * sin_q * fmv;
  const T damp = damp1 + damp2 + damp3;

  const bool r0n = bad || fn[0] || fn[6] || fn[7];
  const bool r1n = bad || fn[1] || fn[6] || fn[7];
  const bool r2n = bad || fn[2] || fn[4] || fn[8] || fn[10];
  const bool r3n = bad || fn[3] || fn[5] || fn[9] || fn[11];
  const bool r4n = bad || ampn || fn[2] || fn[3] || fn[4] || fn[5] || fn[8] ||
                   fn[9] || fn[11] || fn[1];

  const T inv_r = T(1.0 / kRearth);
  const T nan = nan_value<T>();
  dy[0] = r0n ? nan : ug * inv_r;
  dy[1] = r1n ? nan : vg * cos_q * inv_r;
  dy[2] = r2n ? nan : dzwn * inv_r;
  dy[3] = r3n ? nan : dmwn * inv_r;
  dy[4] = r4n ? nan : damp * amp_q * inv_r;
  *err_out = err;

  if constexpr (kGv) {
    group_velocity_masks(fn, g, dead, fmu + q[6], fmv + q[7], ug_raw,
                         vg_raw);
  }
}

template <typename T, class I = Lane, bool kTime = false>
__device__ __forceinline__ void ray_rhs(const Background<T, kTime>& bg,
                                        const T y[5], T t, T dy[5],
                                        bool* err_out) {
  rhs_core<T, I, false>(bg, y, t, dy, err_out, nullptr, nullptr);
}

template <typename T, class I = Lane, bool kTime = false>
__device__ __forceinline__ void ray_rhs(const Background<T, kTime>& bg,
                                        const T y[5], T t, T dy[5],
                                        bool* err_out, T* ug_raw,
                                        T* vg_raw) {
  rhs_core<T, I, true>(bg, y, t, dy, err_out, ug_raw, vg_raw);
}

// models/ray.py group_velocity_at (zero_invalid off) at a state y[5] of
// type T and time t over a background of type F (T = S, a mixed-precision
// state, is not rounded: see the head of this file): a NaN position
// samples the sanitized cell (lon = lat = 0) and gets its NaN back.
template <typename T, typename F, class I = Lane, bool kTime = false>
__device__ __forceinline__ void group_velocity_at(
    const Background<F, kTime>& bg, const T y[5], T t, T* ug, T* vg) {
  const bool posn = isnan(y[0]) || isnan(y[1]);
  // kap's division and the sample's cell's, as one group.
  T num0[3], den0[3], q0[3];
  gv_ratio(y[2], y[3], &num0[0], &den0[0]);
  cell_operands(bg, posn ? T(0) : y[0], posn ? T(0) : y[1], &num0[1],
                &den0[1]);
  I::template divide<T, 3>(num0, den0, q0);
  const GvTerms<T> g = gv_terms(y[2], y[3], q0[0]);
  T f[kHot];
  bool fn[kHot];
  T cos_q, sin_q;
  sample_mercator<T, F, I>(bg, q0[1], q0[2], posn ? T(0) : y[1], t, f, fn,
                           &cos_q, &sin_q);
  T num[2], q[2];
  const T den[2] = {g.denom, g.denom};
  group_velocity_nums(fn[6] ? T(0) : f[6], fn[7] ? T(0) : f[7], g.kap,
                      g.kap2, &num[0], &num[1]);
  I::template divide<T, 2>(num, den, q);
  group_velocity_masks(fn, g, posn, (fn[0] ? T(0) : f[0]) + q[0],
                       (fn[1] ? T(0) : f[1]) + q[1], ug, vg);
}

// models/ray.py kill_mask: |lat| >= pi/2, or the haversine distance from
// (lon_prev, lat_prev) is >= cut_off. NaN states compare false. The
// halvings and squares are exact, as torch's / 2.0 and ** 2 are.
//
// The haversine runs only where a cheap bound cannot rule the kill out.
// With s = |dlat| + |dlon|, sin x <= x and cos <= 1 give a <= (s/2)^2, and
// asin x <= x (1 + 0.571 x^2) on [0, 1], so the distance is at most
// s (1 + s^2) (and at most pi). The float haversine rounds within a few
// ulps of the distance, so where s (1 + s^2), widened by 0.1 %, is under
// cut_off it compares below cut_off too, and the answer is the same. NaN
// or infinite differences fail the test and take the haversine.
//
// I = Split (the whole-run exact kernel's team over a float64 state) spreads
// the haversine over the team by operands: threads 0 and 1 take the two
// sines, then the two cosines, then the two square roots, each with the
// expression above, and shuffles give every thread both.
template <typename T, class I = Lane>
__device__ __forceinline__ bool kill_mask(const T y[5], T lon_prev,
                                          T lat_prev, T cut_off) {
  if (fabs(y[1]) >= T(0.5 * kPi)) return true;
  const T dlon = y[0] - lon_prev;
  const T dlat = y[1] - lat_prev;
  const T s = fabs(dlat) + fabs(dlon);
  if (s * (T(1) + s * s) * T(1.001) < cut_off) return false;
  T ddis;
  if constexpr (I::kThreads > 1) {
    const T half[2] = {dlat / T(2), dlon / T(2)};
    const T lats[2] = {lat_prev, y[1]};
    T sn[2], cs[2];
    I::template share<T, 2>(sin(I::template own<T, 2>(half)), sn);
    I::template share<T, 2>(cos(I::template own<T, 2>(lats)), cs);
    const T a = sn[0] * sn[0] + cs[0] * cs[1] * (sn[1] * sn[1]);
    const T r[2] = {a, T(1) - a};
    T q[2];
    I::template share<T, 2>(sqrt(I::template own<T, 2>(r)), q);
    ddis = fabs(T(2) * atan2(q[0], q[1]));
  } else {
    const T s_lat = sin(dlat / T(2));
    const T s_lon = sin(dlon / T(2));
    const T a = s_lat * s_lat + cos(lat_prev) * cos(y[1]) * (s_lon * s_lon);
    ddis = fabs(T(2) * atan2(sqrt(a), sqrt(T(1) - a)));
  }
  return ddis >= cut_off;
}

}  // namespace rwrt
