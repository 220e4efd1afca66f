// The Li-Yang wave-ray flux binning: the Fun1 thresholds, the continuous
// longitude and the scatter of every valid trajectory point into the four
// flux maps in one pass, one thread per ray; and the Fun2 region pass ("the
// ray ever enters the target box"), one thread per ray.
//
//   flux_kernel<F>      rwrt_flux: the binning of diagnostics/flux.py
//                       wave_ray_flux and wave_ray_flux_chunked on CUDA;
//   region_kernel<F>    rwrt_flux_region: region_mask, and the chunked
//                       path's first pass, on CUDA.
//
// Replaces (rwrt_tpu, fused by XLA there, no Pallas original):
//   diagnostics/flux.py:279-311 _accumulate (the bin indices, the count /
//   cg / amp_cg weights, four scatter-adds), :72-101 threshold_filter,
//   :242-271 _unwrap_lon_block (the unwrap with its carry across time
//   blocks) and :104-137 region_mask / _in_box_arrays. XLA computes these
//   as about 15 passes over the (nt, R) rows and four scatters.
// Plain PyTorch versions: rwrt_tpu_torch/diagnostics/flux.py
// _accumulate_plain and _region_plain, whose expressions and order this
// follows.
//
// What bounds it on an H100. Bytes: at most each point's lon, lat, amp, ug
// and vg (and ky where mwn_max is set) read once, the maps written once: at
// the production size (100,800 rays x 361 rows = 36,388,800 points,
// float32) 727.8 MB, or 873.3 MB with ky, 0.22 ms at 3.35 TB/s; the region
// pass at most lon, lat and amp, 436.7 MB. What a run needs is less: a ray
// the region pass dropped costs the binning its keep byte only, a kept
// ray's ug, vg and ky are read at its live points only, and the region
// pass reads a ray's rows up to the first one in the box (or a ray already
// kept by an earlier block not at all). Operations: ~40 a point, 1.5
// GFLOP at most, 0.02 ms at the 67 TFLOP/s float32 peak. So it is bound by
// bytes; what holds it above that bound are the four atomicAdds a valid
// point makes:
// neighbouring rays of one source sit in the same cell at a step, so the
// adds of a warp land on few addresses and serialise in the L2.
//
// Design: a thread walks its ray's rows t = 0 .. nt - 1 with the unwrap's
// accumulator and the last wrapped row in registers; at each t the warp
// reads 32 neighbouring rays' values, one coalesced load a field. A ray the
// region pass dropped returns at once (keep is final before the first
// block is binned, so its carry is never read: it is written NaN). A point
// that fails the thresholds costs its loads only; a valid one computes
// (ix, iy) and its weights and adds
// into the global maps with native atomics (float32 and float64 on sm_90).
// The maps are not privatised in shared memory: four float32 360 x 90 maps
// are 518 KB, more than the 227 KB a block has.
//
// Exactness against the plain version: the bin of every point and its
// validity are computed by the same expressions (-fmad=false; IEEE division
// by the dtype's rounded deg2rad, as JAX's eager division; the cell width's
// reciprocal in the dtype as a factor, as XLA folds the jitted division by
// a constant; fmod-based remainders as torch.remainder and jnp.remainder
// take them), so the count map is equal to the bit; the other maps are sums
// whose order the atomics leave to the hardware.
#include <cuda_runtime.h>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kDeg2Rad = kPi / 180.0;

// The floating remainder as torch.remainder and jnp.remainder take it:
// fmod, then the divisor added where the signs differ and the remainder is
// not zero.
template <typename F>
__device__ __forceinline__ F floor_rem(F x, F y) {
  F m = fmod(x, y);
  if (m != F(0) && ((y < F(0)) != (m < F(0)))) m = m + y;
  return m;
}

// JAX's clip(int32(x), 0, n - 1): truncation toward zero, NaN to 0.
template <typename F>
__device__ __forceinline__ int bin_index(F x, int n) {
  if (isnan(x) || x <= F(0)) return 0;
  if (x >= F(n - 1)) return n - 1;
  return static_cast<int>(x);
}

template <typename F>
struct FluxArgs {
  // (nt, R) rows of each field, row stride in elements; ky may be null
  // unless the mwn check is on.
  const F* lon;
  const F* lat;
  const F* amp;
  const F* ug;
  const F* vg;
  const F* ky;
  long long s_lon, s_lat, s_amp, s_ug, s_vg, s_ky;
  int nt;
  int R;
  const bool* keep;  // (R,) rays the region pass kept, or null: all
  // The unwrap's carry (R,): the unclipped accumulator and the last wrapped
  // row; read at entry where carry_in, written at exit (NaN for a ray that
  // keep drops).
  F* u_prev;
  F* base_prev;
  bool carry_in;
  F* fu;  // (nlon_bins * nlat_bins) each, zeroed by the caller
  F* fv;
  F* asum;
  F* cnt;
  int nlon_bins, nlat_bins;
  F inv_dlon, inv_dlat;  // 1 / cell width, rounded to F
  F amp_min, amp_max, speed_min, speed_max, mwn_max;
  int checks;  // 1: speed_min, 2: speed_max, 4: mwn_max
  int weight;  // 0: count, 1: cg, 2: amp_cg
};

template <typename F>
__global__ void __launch_bounds__(256) flux_kernel(const FluxArgs<F> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.R) return;
  const F two_pi = F(2.0 * kPi);
  const F pi = F(kPi);
  const F lo = F(-2.0 * kPi);
  const F hi = F(4.0 * kPi);
  const F deg = F(kDeg2Rad);
  const F nan = F(NAN);
  if (a.keep != nullptr && !a.keep[i]) {
    a.u_prev[i] = nan;
    a.base_prev[i] = nan;
    return;
  }

  // unwrapped[t] = start + c[t], c the running sum of the wrapped
  // increments from 0 (jnp.cumsum's order); with no carry row 0 is start.
  F start = F(0), base_prev = F(0), c = F(0), u = F(0);
  if (a.carry_in) {
    start = a.u_prev[i];
    base_prev = a.base_prev[i];
  }
  for (int t = 0; t < a.nt; ++t) {
    const long long tl = t;
    const F lon = a.lon[tl * a.s_lon + i];
    const F base = floor_rem(lon, two_pi);
    if (t == 0 && !a.carry_in) {
      start = base;
      u = start;
    } else {
      F d = base - base_prev;
      d = floor_rem(d + pi, two_pi) - pi;
      if (isnan(d)) d = F(0);
      c = c + d;
      u = start + c;
    }
    base_prev = base;

    // Fun1's thresholds.
    const F lat = a.lat[tl * a.s_lat + i];
    const F amp = a.amp[tl * a.s_amp + i];
    const F aabs = fabs(amp);
    if (!(isfinite(lon) && isfinite(lat) && isfinite(amp) &&
          aabs >= a.amp_min && aabs <= a.amp_max)) {
      continue;
    }
    const F ug = a.ug[tl * a.s_ug + i];
    const F vg = a.vg[tl * a.s_vg + i];
    if (a.checks & 3) {
      const F speed = sqrt(ug * ug + vg * vg);
      if ((a.checks & 1) && !(speed >= a.speed_min)) continue;
      if ((a.checks & 2) && !(speed <= a.speed_max)) continue;
    }
    if ((a.checks & 4) && !(fabs(a.ky[tl * a.s_ky + i]) < a.mwn_max)) {
      continue;
    }

    // The unwrapped longitude as saved: NaN where the wrapped row is, then
    // clipped to the three circles (NaN kept).
    F uo = isnan(base) ? nan : u;
    if (uo < lo) uo = lo;
    if (uo > hi) uo = hi;
    const int ix =
        bin_index((uo / deg + F(360)) * a.inv_dlon, a.nlon_bins);
    const int iy = bin_index((lat / deg + F(90)) * a.inv_dlat, a.nlat_bins);
    const long long cell = static_cast<long long>(ix) * a.nlat_bins + iy;

    F wu, wv;
    if (a.weight == 0) {
      const F speed = sqrt(ug * ug + vg * vg);
      const F safe = speed > F(0) ? speed : F(1);
      wu = ug / safe;
      wv = vg / safe;
    } else if (a.weight == 1) {
      wu = ug;
      wv = vg;
    } else {
      wu = amp * ug;
      wv = amp * vg;
    }
    atomicAdd(a.fu + cell, wu);
    atomicAdd(a.fv + cell, wv);
    atomicAdd(a.asum + cell, aabs);
    atomicAdd(a.cnt + cell, F(1));
  }
  a.u_prev[i] = u;
  a.base_prev[i] = base_prev;
}

template <typename F>
struct RegionArgs {
  const F* lon;
  const F* lat;
  const F* amp;
  long long s_lon, s_lat, s_amp;
  int nt;
  int R;
  int mode;  // 0: every longitude, 1: lo0 <= lon <= lo1, 2: across the
             // date line, lon >= lo0 or lon <= lo1
  F lo0, lo1, la0, la1;
  bool* keep;  // (R,): OR-ed with "a live point of the rows is in the box"
};

// A ray already kept (by an earlier block of the chunked path) reads
// nothing more; another reads its rows up to the first live one in the box.

template <typename F>
__global__ void __launch_bounds__(256) region_kernel(const RegionArgs<F> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.R || a.keep[i]) return;
  const F deg = F(kDeg2Rad);
  for (int t = 0; t < a.nt; ++t) {
    const long long tl = t;
    const F lon = a.lon[tl * a.s_lon + i];
    const F lat = a.lat[tl * a.s_lat + i];
    const F amp = a.amp[tl * a.s_amp + i];
    const F lon_deg = floor_rem(lon / deg, F(360));
    const F lat_deg = lat / deg;
    const bool in_lon =
        a.mode == 0 ? true
        : a.mode == 1 ? (lon_deg >= a.lo0 && lon_deg <= a.lo1)
                      : (lon_deg >= a.lo0 || lon_deg <= a.lo1);
    if (in_lon && lat_deg >= a.la0 && lat_deg <= a.la1 && isfinite(lon) &&
        isfinite(lat) && isfinite(amp)) {
      a.keep[i] = true;
      return;
    }
  }
}

template <typename F>
int launch_flux(const FluxArgs<F>& a, cudaStream_t stream) {
  if (a.R <= 0) return cudaSuccess;
  const int block = 256;
  flux_kernel<F><<<(a.R + block - 1) / block, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename F>
int launch_region(const RegionArgs<F>& a, cudaStream_t stream) {
  if (a.R <= 0 || a.nt <= 0) return cudaSuccess;
  const int block = 256;
  region_kernel<F><<<(a.R + block - 1) / block, block, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define RWRT_FLUX(SUFFIX, F)                                                 \
  int rwrt_flux_##SUFFIX(                                                    \
      const void* lon, const void* lat, const void* amp, const void* ug,     \
      const void* vg, const void* ky, long long s_lon, long long s_lat,      \
      long long s_amp, long long s_ug, long long s_vg, long long s_ky,       \
      int nt, int R, const void* keep, void* u_prev, void* base_prev,        \
      int carry_in, void* fu, void* fv, void* asum, void* cnt,               \
      int nlon_bins, int nlat_bins, double inv_dlon, double inv_dlat,        \
      double amp_min, double amp_max, double speed_min, double speed_max,    \
      double mwn_max, int checks, int weight, void* stream) {                \
    FluxArgs<F> a{};                                                         \
    a.lon = static_cast<const F*>(lon);                                      \
    a.lat = static_cast<const F*>(lat);                                      \
    a.amp = static_cast<const F*>(amp);                                      \
    a.ug = static_cast<const F*>(ug);                                        \
    a.vg = static_cast<const F*>(vg);                                        \
    a.ky = static_cast<const F*>(ky);                                        \
    a.s_lon = s_lon;                                                         \
    a.s_lat = s_lat;                                                         \
    a.s_amp = s_amp;                                                         \
    a.s_ug = s_ug;                                                           \
    a.s_vg = s_vg;                                                           \
    a.s_ky = s_ky;                                                           \
    a.nt = nt;                                                               \
    a.R = R;                                                                 \
    a.keep = static_cast<const bool*>(keep);                                 \
    a.u_prev = static_cast<F*>(u_prev);                                      \
    a.base_prev = static_cast<F*>(base_prev);                                \
    a.carry_in = carry_in != 0;                                              \
    a.fu = static_cast<F*>(fu);                                              \
    a.fv = static_cast<F*>(fv);                                              \
    a.asum = static_cast<F*>(asum);                                          \
    a.cnt = static_cast<F*>(cnt);                                            \
    a.nlon_bins = nlon_bins;                                                 \
    a.nlat_bins = nlat_bins;                                                 \
    a.inv_dlon = F(inv_dlon);                                                \
    a.inv_dlat = F(inv_dlat);                                                \
    a.amp_min = F(amp_min);                                                  \
    a.amp_max = F(amp_max);                                                  \
    a.speed_min = F(speed_min);                                              \
    a.speed_max = F(speed_max);                                              \
    a.mwn_max = F(mwn_max);                                                  \
    a.checks = checks;                                                       \
    a.weight = weight;                                                       \
    return launch_flux<F>(a, static_cast<cudaStream_t>(stream));             \
  }

#define RWRT_FLUX_REGION(SUFFIX, F)                                          \
  int rwrt_flux_region_##SUFFIX(                                             \
      const void* lon, const void* lat, const void* amp, long long s_lon,    \
      long long s_lat, long long s_amp, int nt, int R, int mode, double lo0, \
      double lo1, double la0, double la1, void* keep, void* stream) {        \
    RegionArgs<F> a{};                                                       \
    a.lon = static_cast<const F*>(lon);                                      \
    a.lat = static_cast<const F*>(lat);                                      \
    a.amp = static_cast<const F*>(amp);                                      \
    a.s_lon = s_lon;                                                         \
    a.s_lat = s_lat;                                                         \
    a.s_amp = s_amp;                                                         \
    a.nt = nt;                                                               \
    a.R = R;                                                                 \
    a.mode = mode;                                                           \
    a.lo0 = F(lo0);                                                          \
    a.lo1 = F(lo1);                                                          \
    a.la0 = F(la0);                                                          \
    a.la1 = F(la1);                                                          \
    a.keep = static_cast<bool*>(keep);                                       \
    return launch_region<F>(a, static_cast<cudaStream_t>(stream));           \
  }

RWRT_FLUX(f32, float)
RWRT_FLUX(f64, double)
RWRT_FLUX_REGION(f32, float)
RWRT_FLUX_REGION(f64, double)

#undef RWRT_FLUX
#undef RWRT_FLUX_REGION

}  // extern "C"
