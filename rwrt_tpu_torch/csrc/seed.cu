// The seed stage in one launch: the background sampled at each source, the
// three roots of the dispersion cubic, the initial amplitude and group
// velocity, written as the run's seeds, one thread per (member, source,
// zwn) point.
//
//   seed_kernel<T, kTime>   rwrt_seed (and rwrt_seed_time over a
//                           time-varying or ensemble background):
//                           tracer.initialize on CUDA.
//
// Replaces (rwrt_tpu, fused by XLA there, no Pallas original):
//   tracer.py:85 initialize in canonical root order, over ops/cubic.py:241
//   solve_dispersion_cubic (:87 _roots_from_coeffs, :48
//   _solve_cubic_depressed, :44 _cbrt) and ops/groupvel.py:65
//   group_velocity (zero_invalid).
// Plain PyTorch version: rwrt_tpu_torch/tracer.py _initialize_plain, over
// ops/cubic.py _roots_closed_form and ops/groupvel.py group_velocity; this
// follows their expressions and their order, including the ones PyTorch
// rewrites on CUDA: a tensor over a Python scalar is the tensor times the
// scalar's reciprocal, rounded in the tensor's type (div_true by a CPU
// scalar), a Python scalar over a tensor the tensor's reciprocal times the
// scalar (Tensor.__rtruediv__), x ** 2 and x ** 3 are x * x and x * x * x,
// torch.sign(NaN) is 0, and clamp keeps a NaN. The roots' stable argsort
// is a stable three-element network.
//
// What bounds it on an H100. Per point one 48-value row of the
// L2-resident background (two for a timed sample) and ~320 flops, among
// them two pows, or an acos and three cos; out, three lanes of 7 values.
// At the reference run's 2,205 float64 points that is 0.1 MB of distinct
// rows read and 0.4 MB in and out, 0.14 us at the memory's rate, and the
// threads fit one wave: a launch lasts one thread's chain (the sample, the
// cubic's divisions and transcendentals, the Newton polishes), 7 us
// measured. The work it replaces was ~470 elementwise PyTorch launches,
// 7.5-12 ms of host time for 0.7 ms of device work.
//
// Design. One thread per point, 128 a block, all in registers: the point
// samples at its source once (ray_rhs.cuh's sample_mercator, the Lane
// instance, the lane's member stack by lane_background; a timed stack at
// t = 0), forms c3..c0, finds and orders the roots, and writes its three
// lanes of the (member, root, source, zwn) C-order layout the plain route
// returns. A branch the plain route computes and discards (Cardano or the
// trigonometric form, the quadratic, the linear root) is computed only
// where it is taken: the selects give the same bits. The float64 pow is
// PyTorch's, inline (pow64.cuh). Built with -fmad=false, so each
// expression rounds as the plain version's separate tensor ops do.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include <limits>
#include <type_traits>

#include "pow64.cuh"
#include "ray_rhs.cuh"

namespace {

using rwrt::nan_value;

// |Im| below this makes a conjugate pair real (constants.delt).
constexpr double kDelt = 1.0e-8;

template <typename T, bool kTime>
struct SeedArgs {
  rwrt::Background<T, kTime> bg;
  const T* lon;  // (ns,): the sources
  const T* lat;  // (ns,)
  const T* zwn;  // (nz,)
  int ns, nz;
  int P;   // points: members x ns x nz
  T freq;  // rad/s, in the fields' type
  T* y0;   // (5, 3 P)
  T* ug0;  // (3 P,)
  T* vg0;  // (3 P,)
};

// torch.clamp on CUDA: a NaN kept, else max(x, lower) (and min(., upper)).
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lower) {
  return isnan(x) ? x : fmax(x, lower);
}

template <typename T>
__device__ __forceinline__ T clamp(T x, T lower, T upper) {
  return isnan(x) ? x : fmin(fmax(x, lower), upper);
}

// torch.sign: (0 < x) - (x < 0), so 0 for a NaN.
template <typename T>
__device__ __forceinline__ T sign(T x) {
  return T(int(T(0) < x) - int(x < T(0)));
}

// x ** (1/3) as PyTorch's CUDA pow rounds it: powf in float32,
// libdevice's pow built with contraction in float64 (pow64.cuh).
template <typename T>
__device__ __forceinline__ T third_power(T x) {
  if constexpr (std::is_same<T, double>::value) {
    return rwrt::pow64(x, 1.0 / 3.0);
  } else {
    return pow(x, T(1.0 / 3.0));
  }
}

// cubic.py _cbrt: sign(x) * |x| ** (1/3).
template <typename T>
__device__ __forceinline__ T cbrt_signed(T x) {
  return sign(x) * third_power(fabs(x));
}

// cubic.py _roots_closed_form's polish: two guarded Newton iterations on
// the monic cubic m^3 + b m^2 + c m + d.
template <typename T>
__device__ __forceinline__ T polish(T m, T b, T c, T d) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const T pm = ((m + b) * m + c) * m + d;
    const T dpm = (m * T(3) + b * T(2)) * m + c;
    const T step = pm / (dpm == T(0) ? T(1) : dpm);
    m = m - (fabs(step) < T(0.5) ? step : T(0));
  }
  return m;
}

// The cubic's three roots (NaN where absent) before the window and the
// order: the monic depressed cubic by Cardano (disc > 0) or the
// trigonometric form, shifted back and polished (cubic.py
// _solve_cubic_depressed and the cubic branch of _roots_closed_form).
template <typename T>
__device__ __forceinline__ void cubic_roots(T c3, T c2, T c1, T c0,
                                            T r[3]) {
  const T third = T(1) / T(3);
  const T b = c2 / c3;
  const T c = c1 / c3;
  const T d = c0 / c3;
  const T p = c - b * b * third;
  const T q = b * b * b * T(2) * (T(1) / T(27)) - b * c * third + d;
  const T shift = b * third;

  const T half_q = q * T(0.5);
  const T third_p = p * third;
  const T disc = half_q * half_q + third_p * third_p * third_p;
  T t[3];
  bool pair_real;
  if (disc > T(0)) {
    const T sq = sqrt(clamp_min(disc, T(0)));
    const T u = cbrt_signed(-half_q + sq);
    const T v = cbrt_signed(-half_q - sq);
    const T pair_re = (u + v) * T(-0.5);
    const T pair_im = (u - v) * T(0.8660254037844386);  // sqrt(3) / 2
    t[0] = u + v;
    t[1] = pair_re;
    t[2] = pair_re;
    pair_real = fabs(pair_im) < T(kDelt);
  } else {
    const T guard = std::is_same<T, double>::value ? T(1e-300) : T(1e-30);
    const T mp = sqrt(clamp_min(-third_p, guard));
    const T cos_arg = clamp(-half_q / (mp * mp * mp), T(-1), T(1));
    const T theta = acos(cos_arg) * third;
    const T two_pi_3 = T(2.0 * rwrt::kPi / 3.0);
    const T mp2 = mp * T(2);
    t[0] = mp2 * cos(theta);
    t[1] = mp2 * cos(theta - two_pi_3);
    t[2] = mp2 * cos(theta + two_pi_3);
    pair_real = true;
  }
  // The pair slots are polished only as genuine real roots (the
  // trigonometric branch); a tiny-Im pair keeps its common real part.
  const bool genuine = pair_real && !(disc > T(0));
  r[0] = polish(t[0] - shift, b, c, d);
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const T m = t[k] - shift;
    r[k] = !pair_real ? nan_value<T>() : genuine ? polish(m, b, c, d) : m;
  }
}

// The quadratic c2 m^2 + c1 m + c0's two roots, the pair's common real
// part where |Im| < delt, NaN otherwise.
template <typename T>
__device__ __forceinline__ void quadratic_roots(T c2, T c1, T c0, T r[2]) {
  const T disc2 = c1 * c1 - c2 * T(4) * c0;
  const T sq2 = sqrt(fabs(disc2));
  const T q_im = sq2 / (fabs(c2) * T(2));
  if (!(disc2 >= T(0) || q_im < T(kDelt))) {
    r[0] = r[1] = nan_value<T>();
  } else if (disc2 >= T(0)) {
    const T qq = (c1 + sign(c1 + (c1 == T(0) ? T(1) : T(0))) * sq2) *
                 T(-0.5);
    r[0] = qq != T(0) ? qq / c2 : T(0);
    r[1] = qq != T(0) ? c0 / qq : T(0);
  } else {
    r[0] = r[1] = -c1 / (c2 * T(2));
  }
}

// cubic.py _roots_closed_form: the real roots of c3 m^3 + c2 m^2 + c1 m +
// c0 of the |m| < mwn_cap window (zwn != 0), NaN-padded, in canonical
// slot order.
template <typename T>
__device__ __forceinline__ void dispersion_roots(T c3, T c2, T c1, T c0,
                                                 bool nonzero_k, T m[3]) {
  // The effective degree over the root window: demote while the leading
  // term's largest contribution is below tau of the largest one.
  const T tau =
      T(1e4 * (std::is_same<T, double>::value ? DBL_EPSILON : FLT_EPSILON));
  const T cap = T(rwrt::kMwnCap);
  const T s3 = fabs(c3) * T(rwrt::kMwnCap * rwrt::kMwnCap * rwrt::kMwnCap);
  const T s2 = fabs(c2) * T(rwrt::kMwnCap * rwrt::kMwnCap);
  const T s1 = fabs(c1) * cap;
  const T s0 = fabs(c0);
  // torch.maximum keeps a NaN; the comparisons below then all fail.
  const T m32 = isnan(s3) || isnan(s2) ? nan_value<T>() : fmax(s3, s2);
  const T m10 = isnan(s1) || isnan(s0) ? nan_value<T>() : fmax(s1, s0);
  const T smax = isnan(m32) || isnan(m10) ? nan_value<T>() : fmax(m32, m10);
  const T thresh = smax * tau;
  const bool nontrivial = smax > T(0);
  const bool deg3 = s3 >= thresh && nontrivial;
  const bool deg2 = !(s3 >= thresh) && s2 >= thresh && nontrivial;
  const bool deg1 =
      !(s3 >= thresh) && !(s2 >= thresh) && s1 >= thresh && nontrivial;

  T r[3] = {nan_value<T>(), nan_value<T>(), nan_value<T>()};
  if (deg3) {
    cubic_roots(c3, c2, c1, c0, r);
  } else if (deg2) {
    quadratic_roots(c2, c1, c0, r);
  } else if (deg1) {
    r[0] = -c0 / c1;
  }

  // The window: finite, |m| < mwn_cap, zwn != 0.
  T key[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (!(isfinite(r[k]) && fabs(r[k]) < cap && nonzero_k)) {
      r[k] = nan_value<T>();
    }
    key[k] = isnan(r[k]) ? T(INFINITY)
                         : fabs(r[k]) + (r[k] < T(0) ? T(1) : T(0)) * T(200);
  }
  // Canonical order, (negative?, |m|) ascending and NaN last: a stable
  // sort, each pair swapped only on a strictly greater key.
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int i = pass == 1 ? 1 : 0;
    if (key[i] > key[i + 1]) {
      const T kk = key[i];
      key[i] = key[i + 1];
      key[i + 1] = kk;
      const T rr = r[i];
      r[i] = r[i + 1];
      r[i + 1] = rr;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) m[k] = r[k];
}

template <typename T, bool kTime>
__global__ void __launch_bounds__(rwrt::kBlock)
    seed_kernel(const SeedArgs<T, kTime> a) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.P) return;
  const int points = a.ns * a.nz;  // a member's
  const int member = p / points;
  const int rem = p - member * points;
  const int s = rem / a.nz;
  const int z = rem - s * a.nz;
  const long long block = static_cast<long long>(member) * 3 * points;
  // The member its source's lanes map to: the map at root 0, zwn 0.
  const auto& bg =
      rwrt::lane_background(a.bg, static_cast<int>(block) + s * a.nz);

  const T lon = a.lon[s], lat = a.lat[s], kx = a.zwn[z];
  T num[2], den[2];
  rwrt::cell_operands(bg, lon, lat, num, den);
  T f[rwrt::kHot];
  bool fn[rwrt::kHot];
  T cos_q, sin_q;
  rwrt::sample_mercator<T, T, rwrt::Lane>(bg, num[0] / den[0],
                                          num[1] / den[1], lat, T(0), f, fn,
                                          &cos_q, &sin_q);
  const T fu = f[0], fv = f[1], fqx = f[6], fqy = f[7];

  // cubic.py solve_dispersion_cubic's coefficients.
  const bool nonzero_k = kx != T(0);
  const T kz = nonzero_k ? kx : T(1);
  const T ps = T(1) / kz * a.freq * T(rwrt::kRearth);
  const T c3 = fv;
  const T c2 = kz * (fu - ps);
  const T c1 = kz * kz * fv + fqx;
  const T c0 = kz * kz * kz * (fu - ps) - fqy * kz;
  T m[3];
  dispersion_roots(c3, c2, c1, c0, nonzero_k, m);

  // Each root's lane: amp 1 where the root exists, (ug, vg) with
  // group_velocity's zero-invalid semantics.
  const long long R = 3LL * a.P;
  const T fqx_s = fn[6] ? T(0) : fqx;
  const T fqy_s = fn[7] ? T(0) : fqy;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long lane = block + static_cast<long long>(k) * points + rem;
    T mwn_s, zwn_s;
    rwrt::gv_ratio(kx, m[k], &mwn_s, &zwn_s);
    const rwrt::GvTerms<T> g = rwrt::gv_terms(kx, m[k], mwn_s / zwn_s);
    T nu, nv;
    rwrt::group_velocity_nums(fqx_s, fqy_s, g.kap, g.kap2, &nu, &nv);
    T ug, vg;
    rwrt::group_velocity_masks(fn, g, false, (fn[0] ? T(0) : fu) + nu / g.denom,
                               (fn[1] ? T(0) : fv) + nv / g.denom, &ug, &vg);
    if (!nonzero_k) ug = vg = T(0);
    a.y0[lane] = lon;
    a.y0[R + lane] = lat;
    a.y0[2 * R + lane] = kx;
    a.y0[3 * R + lane] = m[k];
    a.y0[4 * R + lane] = isnan(m[k]) ? nan_value<T>() : T(1);
    a.ug0[lane] = ug;
    a.vg0[lane] = vg;
  }
}

template <typename T, bool kTime>
int run_seed(const rwrt::Background<T, kTime>& bg, const void* lon,
             const void* lat, const void* zwn, int ns, int nz, int members,
             double freq, void* y0, void* ug0, void* vg0, void* stream) {
  const long long P = static_cast<long long>(members) * ns * nz;
  if (P <= 0) return cudaSuccess;
  if (3 * P > std::numeric_limits<int>::max()) return cudaErrorInvalidValue;
  SeedArgs<T, kTime> a{};
  a.bg = bg;
  a.lon = static_cast<const T*>(lon);
  a.lat = static_cast<const T*>(lat);
  a.zwn = static_cast<const T*>(zwn);
  a.ns = ns;
  a.nz = nz;
  a.P = static_cast<int>(P);
  a.freq = T(freq);
  a.y0 = static_cast<T*>(y0);
  a.ug0 = static_cast<T*>(ug0);
  a.vg0 = static_cast<T*>(vg0);
  const int grid = static_cast<int>((P + rwrt::kBlock - 1) / rwrt::kBlock);
  seed_kernel<T, kTime>
      <<<grid, rwrt::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define RWRT_SEED(SUFFIX, T)                                                  \
  int rwrt_seed_##SUFFIX(const void* packed, int W, int H, double lon0,       \
                         double lat0, double dx, double dy, const void* lon,  \
                         const void* lat, const void* zwn, int ns, int nz,    \
                         int members, double freq, void* y0, void* ug0,       \
                         void* vg0, void* stream) {                           \
    return run_seed<T, false>(                                                \
        rwrt::make_background<T>(packed, W, H, lon0, lat0, dx, dy), lon, lat, \
        zwn, ns, nz, members, freq, y0, ug0, vg0, stream);                    \
  }
#define RWRT_SEED_TIME(SUFFIX, T)                                             \
  int rwrt_seed_time_##SUFFIX(                                                \
      const void* packed, int W, int H, double lon0, double lat0, double dx,  \
      double dy, int nt, int timed, double t0, double tdt,                    \
      const void* member, const void* lon, const void* lat, const void* zwn,  \
      int ns, int nz, int members, double freq, void* y0, void* ug0,          \
      void* vg0, void* stream) {                                              \
    return run_seed<T, true>(                                                 \
        rwrt::make_background<T>(packed, W, H, lon0, lat0, dx, dy, nt, timed, \
                                 t0, tdt, member),                            \
        lon, lat, zwn, ns, nz, members, freq, y0, ug0, vg0, stream);          \
  }

// Every instance in this one unit: a short kernel with no loop, it
// compiles in a few seconds beside the integrators' units.
RWRT_SEED(f32, float)
RWRT_SEED(f64, double)
RWRT_SEED_TIME(f32, float)
RWRT_SEED_TIME(f64, double)

#undef RWRT_SEED
#undef RWRT_SEED_TIME

}  // extern "C"
