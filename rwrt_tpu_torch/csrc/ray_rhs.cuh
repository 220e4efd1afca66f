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
// plus ~150 flops and two sin/cos pairs. The background fits the 50 MB L2
// many times over, so the gather is an L2 hit after warm-up; the arithmetic
// is short, so latency of the dependent gather dominates a single call.
// Design: the row is read with __ldg through the read-only path, the cell
// index is computed first so the 48 loads go out back to back, and every
// NaN rule is an explicit mask (never IEEE propagation), as in the plain
// version, so kx = 0 or infinite inputs give the same NaN pattern.
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

template <typename T>
struct Background {
  const T* packed;  // (W, H, 48): [F(w,h), F(w+1,h), F(w,h+1), F(w+1,h+1)]
  int W;
  int H;
  T lon0, lat0, dx, dy;
};

template <typename T>
__device__ __forceinline__ T nan_value() {
  return static_cast<T>(NAN);
}

// Floor mod with the divisor's sign, as jnp/torch remainder.
template <typename T>
__device__ __forceinline__ T floor_mod(T x, T m) {
  T r = fmod(x, m);
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

// Group velocity on sanitized (NaN-free) inputs: groupvel.py core.
template <typename T>
__device__ __forceinline__ void group_velocity_clean(T fu, T fv, T fqx, T fqy,
                                                     T zwn, T mwn, T* ug,
                                                     T* vg) {
  T kap = mwn / zwn;
  T kap2 = kap * kap;
  T kap1 = T(1) + kap2;
  T denom = zwn * zwn * kap1 * kap1;
  *ug = fu + ((T(1) - kap2) * fqy - T(2) * kap * fqx) / denom;
  *vg = fv + (T(2) * kap * fqy + (T(1) - kap2) * fqx) / denom;
}

// Mercator sample of the 12 hot fields at a (sanitized) position.
// f[] receives the M_* fields, fn[] their NaN flags; cos/sin of lat are
// returned for reuse.
template <typename T>
__device__ __forceinline__ void sample_mercator(const Background<T>& bg,
                                                T lon, T lat, T f[kHot],
                                                bool fn[kHot], T* cos_out,
                                                T* sin_out) {
  const T two_pi = T(2.0 * kPi);
  T ix = floor_mod(lon - bg.lon0, two_pi) / bg.dx;
  T iy = (lat - bg.lat0) / bg.dy;
  int x0 = cell_index(ix, bg.W);
  int y0 = cell_index(iy, bg.H);
  T sx = ix - T(x0);
  T sy = iy - T(y0);
  const T* row = bg.packed + (static_cast<long long>(x0) * bg.H + y0) * kPacked;
  // The row by 16-byte loads: 12 (float32) or 24 (float64) instead of 48,
  // which the scattered rows of a warp otherwise pay for one by one. A row
  // is 192 or 384 B and the wrappers check that the stack is 16-B aligned.
  T rv[kPacked];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int q = 0; q < kPacked / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(row) + q);
      rv[4 * q] = x.x;
      rv[4 * q + 1] = x.y;
      rv[4 * q + 2] = x.z;
      rv[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPacked / 2; ++q) {
      const double2 x = __ldg(reinterpret_cast<const double2*>(row) + q);
      rv[2 * q] = x.x;
      rv[2 * q + 1] = x.y;
    }
  }
  T wa = (T(1) - sx) * sy;
  T wb = sx * sy;
  T wc = (T(1) - sx) * (T(1) - sy);
  T wd = sx * (T(1) - sy);
  bool in_range = fabs(lat) <= T(0.5 * kPi);
  T raw[kHot];
#pragma unroll
  for (int c = 0; c < kHot; ++c) {
    T fc = rv[c];             // (x0, y0)
    T fd = rv[kHot + c];      // (x1, y0)
    T fa = rv[2 * kHot + c];  // (x0, y1)
    T fb = rv[3 * kHot + c];  // (x1, y1)
    T v = fa * wa + fb * wb + fc * wc + fd * wd;
    raw[c] = in_range ? v : nan_value<T>();
  }

  T cos_phi = cos(lat);
  T sin_phi = sin(lat);
  bool live = !(fabs(cos_phi) <= T(kPolarCosCap));
  T cosm = live ? cos_phi : T(1e-6);
  T tan_phi = sin_phi / cosm;
  // Field order: u v ux uy vx vy qx qy qxx qxy qyx qyy.
  T fmqyx = raw[9] * cosm;
  f[0] = raw[0] / cosm;
  f[1] = raw[1] / cosm;
  f[2] = raw[2] / cosm;
  f[3] = raw[3] + tan_phi * raw[0];
  f[4] = raw[4] / cosm;
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

// group_velocity on a raw sample f (NaN flags fn) and raw (kx, ky):
// NaN-free substitutes, then the IEEE-propagation masks (ug: fu, qx, qy,
// kx, ky; vg: fv, qx, qy, kx, ky), then `dead` -> NaN.
template <typename T>
__device__ __forceinline__ void group_velocity_masked(const T f[kHot],
                                                      const bool fn[kHot],
                                                      T kx, T ky, bool dead,
                                                      T* ug, T* vg) {
  const bool nk = isnan(kx), nm = isnan(ky);
  T gu, gv;
  group_velocity_clean(fn[0] ? T(0) : f[0], fn[1] ? T(0) : f[1],
                       fn[6] ? T(0) : f[6], fn[7] ? T(0) : f[7],
                       nk ? T(1) : kx, nm ? T(0) : ky, &gu, &gv);
  const bool shared = fn[6] || fn[7] || nk || nm;
  *ug = (dead || fn[0] || shared) ? nan_value<T>() : gu;
  *vg = (dead || fn[1] || shared) ? nan_value<T>() : gv;
}

// dy/dt of one lane. Writes dy[5] and the err flag; when ug_raw is not
// null also the raw-ky group velocity of the evaluated state (rhs_and_gv).
template <typename T>
__device__ __forceinline__ void ray_rhs(const Background<T>& bg, const T y[5],
                                        T dy[5], bool* err_out,
                                        T* ug_raw = nullptr,
                                        T* vg_raw = nullptr) {
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

  T f[kHot];
  bool fn[kHot];
  T cos_q, sin_q;
  sample_mercator(bg, lon_q, lat_q, f, fn, &cos_q, &sin_q);
  T fq[kHot];
#pragma unroll
  for (int c = 0; c < kHot; ++c) fq[c] = fn[c] ? T(0) : f[c];
  const T fmu = fq[0], fmv = fq[1], fmux = fq[2], fmuy = fq[3];
  const T fmvx = fq[4], fmvy = fq[5], fmqx = fq[6], fmqy = fq[7];
  const T fmqxx = fq[8], fmqxy = fq[9], fmqyx = fq[10], fmqyy = fq[11];

  T ug, vg;
  group_velocity_clean(fmu, fmv, fmqx, fmqy, kx_q, ky_q, &ug, &vg);

  const T kap = ky_q / kx_q;
  const T kap2 = kap * kap;
  const T kap1 = T(1) + kap2;
  const T kk = kx_q * kx_q * kap1;

  const T dzwn = -kx_q * ((fmux + kap * fmvx) + (kap * fmqxx - fmqyx) / kk);
  const T dmwn = -kx_q * ((fmuy + kap * fmvy) + (kap * fmqxy - fmqyy) / kk);

  const T damp1 = T(2) * (fmux + fmvy + kap * (fmvx + fmuy)) / kap1;
  const T damp2 =
      T(2) * (kap * (fmqxx - fmqyy) + (kap2 - T(1)) * fmqxy) / (kk * kap1);
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

  if (ug_raw != nullptr) {
    group_velocity_masked(f, fn, kx, ky, dead, ug_raw, vg_raw);
  }
}

// models/ray.py group_velocity_at (zero_invalid off) at a state y[5]: a NaN
// position samples the sanitized cell (lon = lat = 0) and gets its NaN back.
template <typename T>
__device__ __forceinline__ void group_velocity_at(const Background<T>& bg,
                                                  const T y[5], T* ug,
                                                  T* vg) {
  const bool posn = isnan(y[0]) || isnan(y[1]);
  T f[kHot];
  bool fn[kHot];
  T cos_q, sin_q;
  sample_mercator(bg, posn ? T(0) : y[0], posn ? T(0) : y[1], f, fn, &cos_q,
                  &sin_q);
  group_velocity_masked(f, fn, y[2], y[3], posn, ug, vg);
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
template <typename T>
__device__ __forceinline__ bool kill_mask(const T y[5], T lon_prev,
                                          T lat_prev, T cut_off) {
  if (fabs(y[1]) >= T(0.5 * kPi)) return true;
  const T dlon = y[0] - lon_prev;
  const T dlat = y[1] - lat_prev;
  const T s = fabs(dlat) + fabs(dlon);
  if (s * (T(1) + s * s) * T(1.001) < cut_off) return false;
  const T s_lat = sin(dlat / T(2));
  const T s_lon = sin(dlon / T(2));
  const T a = s_lat * s_lat + cos(lat_prev) * cos(y[1]) * (s_lon * s_lon);
  const T ddis = fabs(T(2) * atan2(sqrt(a), sqrt(T(1) - a)));
  return ddis >= cut_off;
}

}  // namespace rwrt
