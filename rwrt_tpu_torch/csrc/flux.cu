// The Li-Yang wave-ray flux binning: the Fun1 thresholds, the continuous
// longitude and the scatter of every valid trajectory point into the four
// flux maps; and the Fun2 region pass ("the ray ever enters the target
// box"), 32 rays a block in tiles of rows.
//
//   compact_kernel<F>,  rwrt_flux: the binning of diagnostics/flux.py
//   unwrap_kernel<F>,   wave_ray_flux and wave_ray_flux_chunked on CUDA,
//   points_kernel<F>,   four launches (three in float64; see Design);
//   maps_kernel
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
// bytes. What held the first port (one thread a ray walking its rows, four
// atomicAdds a valid point) at 26x that bound:
// warps of one thread a ray carried the few rays the region pass kept
// (21,935 of 100,800 at the production size); each thread walked its 361
// rows one after another, several dependent loads a row, ~166 threads an
// SM; and every valid point made four global atomicAdds, neighbouring rays
// of one source adding into one cell at a step, serialised in the L2.
//
// Design. The only sequential carry is the unwrap's running sum, which
// must stay in jnp.cumsum's order (row by row from 0), or the bins move.
// So it is the only part done in order, and everything else runs in
// parallel over (row, kept ray) points:
//   compact_kernel  the kept rays' list: each block of 256 rays packs its
//                   kept rays in order and takes their slots with one
//                   atomicAdd; a dropped ray's carry is NaN.
//   unwrap_kernel   32 kept rays a block of 8 warps, 64 rows at a time in
//                   shared memory: the wrapped rows and their increments
//                   over all 8 warps, the running sum by one warp (one
//                   add a row, the increments read from shared memory),
//                   the longitude bins over all 8 warps, written to an
//                   (nt, R) int32 scratch by slot (-1 where lon is not
//                   finite), coalesced; the carry.
//   points_kernel   tiles of 256 slots at kSpan rows, a persistent grid.
//                   A thread issues its rows' loads at once (the bin, lat,
//                   amp, ug, vg, ky), applies Fun1's thresholds, bins the latitude
//                   and weighs each point; consecutive points in one cell
//                   are summed in registers; then the lanes of the warp
//                   that add into one cell find each other
//                   (__match_any_sync) and one of them adds their sums: in
//                   float32 one 16-byte vector atomicAdd (sm_90) into the
//                   four sums interleaved by cell, in float64 four adds.
//   maps_kernel     float32: the interleaved sums into the four maps.
//   region_kernel   the region pass, apart (rwrt_flux_region): 32 rays a
//                   block of 8 warps, so a warp reads a row's rays as one
//                   line, their rows 64 at a time, 8 rows a thread whose
//                   loads are all issued before any is tested; the hits
//                   OR-ed per ray in shared memory after each tile, and a
//                   ray with a hit, or already kept, reads no further
//                   tile. Its first port gave each ray one thread walking
//                   its rows in order with an exit after each row, so a
//                   row's loads waited for the test of the row before: a
//                   chain of 361 memory latencies (0.36 ms at the
//                   production size, 3.3x its bound; PERF.md section 6).
// The maps are not privatised in shared memory: four float32 360 x 90 maps
// are 518 KB, more than the 227 KB a block has. What holds the design
// above its bound (PERF.md section 6): the kept rays lie scattered among
// the dropped ones, so their rows are read at the memory's 32-byte
// sectors, about 3x the bytes of their values at the production size;
// then the adds. Neither the point pass's occupancy nor its reductions'
// shuffles move it.
//
// Exactness against the plain version: the bin of every point and its
// validity are computed by the same expressions (-fmad=false; IEEE division
// by the dtype's rounded deg2rad, as JAX's eager division; the cell width's
// reciprocal in the dtype as a factor, as XLA folds the jitted division by
// a constant; fmod-based remainders as torch.remainder and jnp.remainder
// take them), and the running sum keeps its order, so the count map and the
// carry are equal to the bit (a cell's count, a sum of whole numbers below
// 2^24, is exact in any order); the other maps are sums whose order the
// atomics, the list and the warp's groups leave to the hardware.
#include <cuda_runtime.h>

#include <type_traits>

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
  // Scratch: the kept rays by slot (R,), their count (zeroed by the entry
  // point), each point's longitude bin by row and slot (nt, R), and in
  // float32 the interleaved sums (zeroed by the entry point).
  int* rays;
  int* n_kept;
  int* ixs;
  float* acc;  // float32: the maps' sums interleaved, (cells, 4)
};

// Fun1's amplitude test and the finite lat and amp of a point.
template <typename F>
__device__ __forceinline__ bool live_point(const FluxArgs<F>& a, F lat,
                                           F amp) {
  const F aabs = fabs(amp);
  return isfinite(lat) && isfinite(amp) && aabs >= a.amp_min &&
         aabs <= a.amp_max;
}

// Fun1's speed and wavenumber tests of a live point.
template <typename F>
__device__ __forceinline__ bool passes(const FluxArgs<F>& a, F ug, F vg,
                                       F ky) {
  if (a.checks & 3) {
    const F speed = sqrt(ug * ug + vg * vg);
    if ((a.checks & 1) && !(speed >= a.speed_min)) return false;
    if ((a.checks & 2) && !(speed <= a.speed_max)) return false;
  }
  return !(a.checks & 4) || fabs(ky) < a.mwn_max;
}

// The point's weights (wu, wv) by a.weight.
template <typename F>
__device__ __forceinline__ void weights(const FluxArgs<F>& a, F amp, F ug,
                                        F vg, F* wu, F* wv) {
  if (a.weight == 0) {
    const F speed = sqrt(ug * ug + vg * vg);
    const F safe = speed > F(0) ? speed : F(1);
    *wu = ug / safe;
    *wv = vg / safe;
  } else if (a.weight == 1) {
    *wu = ug;
    *wv = vg;
  } else {
    *wu = amp * ug;
    *wv = amp * vg;
  }
}

constexpr int kFluxBlock = 256;
constexpr unsigned kFull = 0xffffffffu;
// The unwrap pass: kept rays a block takes (a warp's width) and rows staged
// in shared memory at a time.
constexpr int kTile = 32;
constexpr int kChunk = 64;
// The rows a thread of the point pass takes (its loads are issued ahead,
// all at once); its consecutive points in one cell are summed before the
// warp's adds.
constexpr int kSpan = 4;

// The kept rays' list: each block of kFluxBlock rays packs its kept rays,
// in order, into slots it takes with one atomicAdd; a dropped ray's carry
// is NaN (keep is final before the first block is binned).
template <typename F>
__global__ void __launch_bounds__(kFluxBlock) compact_kernel(
    const FluxArgs<F> a) {
  __shared__ int warp_off[kFluxBlock / 32];
  __shared__ int block_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kFluxBlock + threadIdx.x;
  const bool in = i < a.R;
  const bool kept = in && (a.keep == nullptr || a.keep[i]);
  if (in && !kept) {
    a.u_prev[i] = F(NAN);
    a.base_prev[i] = F(NAN);
  }
  const unsigned ballot = __ballot_sync(kFull, kept);
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kFluxBlock / 32; ++w) {
      const int n = warp_off[w];
      warp_off[w] = total;
      total += n;
    }
    block_base = total ? atomicAdd(a.n_kept, total) : 0;
  }
  __syncthreads();
  if (kept) {
    a.rays[block_base + warp_off[warp] +
           __popc(ballot & ((1u << lane) - 1u))] = i;
  }
}

// The unwrap of kTile kept rays (lane l of every warp: slot
// blockIdx.x * kTile + l), kChunk rows at a time: the wrapped rows and their
// increments in parallel over the block's 8 warps, the running sum in
// jnp.cumsum's order by warp 0 alone (one add a row, from shared memory),
// then the longitude bins in parallel, -1 where lon is not finite. The
// carry: the last row's unclipped unwrap and wrapped row.
template <typename F>
__global__ void __launch_bounds__(kFluxBlock) unwrap_kernel(
    const FluxArgs<F> a) {
  __shared__ F s_base[kChunk][kTile];  // the wrapped rows
  __shared__ F s_u[kChunk][kTile];     // increments, then the unwrap
  __shared__ F s_prev[kTile];          // the wrapped row before the chunk
  const int K = *a.n_kept;
  if (blockIdx.x * kTile >= K) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kFluxBlock / 32;
  const int slot = blockIdx.x * kTile + lane;
  const bool in = slot < K;
  const int r = in ? a.rays[slot] : 0;
  const F two_pi = F(2.0 * kPi);
  const long long RL = a.R;
  // Warp 0's running sum: unwrapped[t] = start + c[t], c the sum of the
  // increments from 0; with no carry row 0 is start.
  F start = F(0), c = F(0), u = F(0), base_prev = F(0);
  bool first = !a.carry_in;
  if (warp == 0) {
    if (a.carry_in && in) {
      start = a.u_prev[r];
      base_prev = a.base_prev[r];
    }
    s_prev[lane] = base_prev;
  }
  __syncthreads();
  for (int t0 = 0; t0 < a.nt; t0 += kChunk) {
    const int rows = min(kChunk, a.nt - t0);
#pragma unroll
    for (int q = 0; q < kChunk / kWarps; ++q) {
      const int j = warp + q * kWarps;
      if (j < rows) {
        const F lon = in ? a.lon[(t0 + j) * a.s_lon + r] : F(0);
        s_base[j][lane] = floor_rem(lon, two_pi);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kChunk / kWarps; ++q) {
      const int j = warp + q * kWarps;
      if (j < rows) {
        F d = s_base[j][lane] - (j ? s_base[j - 1][lane] : s_prev[lane]);
        d = floor_rem(d + F(kPi), two_pi) - F(kPi);
        if (isnan(d)) d = F(0);
        s_u[j][lane] = d;
      }
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll 8
      for (int j = 0; j < rows; ++j) {
        if (first) {
          start = s_base[j][lane];
          u = start;
          first = false;
        } else {
          c = c + s_u[j][lane];
          u = start + c;
        }
        s_u[j][lane] = u;
      }
      base_prev = s_base[rows - 1][lane];
      s_prev[lane] = base_prev;
    }
    __syncthreads();
    // The unwrapped longitude as saved (the row is finite here), clipped
    // to the three circles (NaN kept), then binned.
#pragma unroll
    for (int q = 0; q < kChunk / kWarps; ++q) {
      const int j = warp + q * kWarps;
      if (j < rows && in) {
        int ix = -1;
        if (!isnan(s_base[j][lane])) {
          F uo = s_u[j][lane];
          if (uo < F(-2.0 * kPi)) uo = F(-2.0 * kPi);
          if (uo > F(4.0 * kPi)) uo = F(4.0 * kPi);
          ix = bin_index((uo / F(kDeg2Rad) + F(360)) * a.inv_dlon,
                         a.nlon_bins);
        }
        a.ixs[(t0 + j) * RL + slot] = ix;
      }
    }
    __syncthreads();
  }
  if (warp == 0 && in) {
    a.u_prev[r] = u;
    a.base_prev[r] = base_prev;
  }
}

// Adds the lanes' entries (has: the lane holds one) into the maps: the
// lanes with one cell sum their entries (in lane order) and the lowest of
// them adds the sums, in float32 with one 16-byte vector atomicAdd into
// the interleaved (cell, 4) scratch (sm_90), in float64 with four. Every
// lane of the warp calls it.
template <typename F>
__device__ __forceinline__ void warp_add(const FluxArgs<F>& a, bool has,
                                         int cell, F wu, F wv, F aabs,
                                         int n) {
  const unsigned live = __ballot_sync(kFull, has);
  if (!has) return;
  const unsigned grp = __match_any_sync(live, cell);
  F s0 = F(0), s1 = F(0), s2 = F(0);
  int sn = 0;
  for (unsigned m = grp; m; m &= m - 1u) {
    const int src = __ffs(m) - 1;
    s0 = s0 + __shfl_sync(grp, wu, src);
    s1 = s1 + __shfl_sync(grp, wv, src);
    s2 = s2 + __shfl_sync(grp, aabs, src);
    sn += __shfl_sync(grp, n, src);
  }
  if ((threadIdx.x & 31) != __ffs(grp) - 1) return;
  if constexpr (std::is_same<F, float>::value) {
    atomicAdd(reinterpret_cast<float4*>(a.acc) + cell,
              make_float4(s0, s1, s2, float(sn)));
  } else {
    atomicAdd(a.fu + cell, s0);
    atomicAdd(a.fv + cell, s1);
    atomicAdd(a.asum + cell, s2);
    atomicAdd(a.cnt + cell, F(sn));
  }
}

// Every (row, kept ray) point (see the head of this file): tiles of
// kFluxBlock slots over kSpan rows, a persistent grid. A thread issues
// every load of its rows at once, then bins them in order.
template <typename F>
__global__ void __launch_bounds__(kFluxBlock) points_kernel(
    const FluxArgs<F> a) {
  const int K = *a.n_kept;
  const int ktiles = (K + kFluxBlock - 1) / kFluxBlock;
  const int spans = (a.nt + kSpan - 1) / kSpan;
  const long long tiles = static_cast<long long>(ktiles) * spans;
  const long long RL = a.R;
  const bool mwn = a.checks & 4;
  for (long long w = blockIdx.x; w < tiles; w += gridDim.x) {
    const int tb = static_cast<int>(w / ktiles);
    const int k = static_cast<int>(w % ktiles) * kFluxBlock + threadIdx.x;
    const bool in = k < K;
    const int r = in ? a.rays[k] : 0;
    const int t0 = tb * kSpan;
    const int rows = min(kSpan, a.nt - t0);
    int ix[kSpan];
    F lat[kSpan], amp[kSpan], ug[kSpan], vg[kSpan], ky[kSpan];
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      const long long t = t0 + j;
      const bool at = in && j < rows;
      ix[j] = at ? a.ixs[t * RL + k] : -1;
      lat[j] = at ? a.lat[t * a.s_lat + r] : F(0);
      amp[j] = at ? a.amp[t * a.s_amp + r] : F(0);
      ug[j] = at ? a.ug[t * a.s_ug + r] : F(0);
      vg[j] = at ? a.vg[t * a.s_vg + r] : F(0);
      ky[j] = at && mwn ? a.ky[t * a.s_ky + r] : F(0);
    }
    // The run of consecutive points in one cell, summed in registers.
    bool has = false;
    int rcell = 0, rn = 0;
    F ru = F(0), rv = F(0), ra = F(0);
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      bool ok = ix[j] >= 0 && live_point(a, lat[j], amp[j]) &&
                passes(a, ug[j], vg[j], ky[j]);
      int cell = 0;
      F wu = F(0), wv = F(0), aabs = F(0);
      if (ok) {
        const int iy = bin_index(
            (lat[j] / F(kDeg2Rad) + F(90)) * a.inv_dlat, a.nlat_bins);
        cell = ix[j] * a.nlat_bins + iy;
        aabs = fabs(amp[j]);
        weights(a, amp[j], ug[j], vg[j], &wu, &wv);
      }
      const bool flush = ok && has && cell != rcell;
      warp_add(a, flush, rcell, ru, rv, ra, rn);
      if (ok) {
        if (has && cell == rcell) {
          ru = ru + wu;
          rv = rv + wv;
          ra = ra + aabs;
          ++rn;
        } else {
          has = true;
          rcell = cell;
          ru = wu;
          rv = wv;
          ra = aabs;
          rn = 1;
        }
      }
    }
    warp_add(a, has, rcell, ru, rv, ra, rn);
  }
}

// float32: the interleaved (cell, 4) sums into the four maps.
__global__ void __launch_bounds__(kFluxBlock) maps_kernel(
    const FluxArgs<float> a) {
  const int cell = blockIdx.x * kFluxBlock + threadIdx.x;
  if (cell >= a.nlon_bins * a.nlat_bins) return;
  const float4 s = reinterpret_cast<const float4*>(a.acc)[cell];
  a.fu[cell] = s.x;
  a.fv[cell] = s.y;
  a.asum[cell] = s.z;
  a.cnt[cell] = s.w;
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

// The region pass's tiles: a block takes kRegionRays rays, so that one
// warp reads a row's rays as one 128-byte line (float32), and walks their
// rows kRegionTile at a time, kRegionSpan rows a thread, each warp its own
// rows of the tile.
constexpr int kRegionRays = 32;
constexpr int kRegionWarps = 8;
constexpr int kRegionSpan = 8;
constexpr int kRegionTile = kRegionWarps * kRegionSpan;

// A live point in the box: _in_box_arrays' expressions in its order.
template <typename F>
__device__ __forceinline__ bool in_box(const RegionArgs<F>& a, F lon, F lat,
                                       F amp) {
  const F deg = F(kDeg2Rad);
  const F lon_deg = floor_rem(lon / deg, F(360));
  const F lat_deg = lat / deg;
  const bool in_lon =
      a.mode == 0 ? true
      : a.mode == 1 ? (lon_deg >= a.lo0 && lon_deg <= a.lo1)
                    : (lon_deg >= a.lo0 || lon_deg <= a.lo1);
  return in_lon && lat_deg >= a.la0 && lat_deg <= a.la1 && isfinite(lon) &&
         isfinite(lat) && isfinite(amp);
}

// One block per kRegionRays rays. A ray already kept (by an earlier block
// of the chunked path) reads nothing; another reads its rows a tile at a
// time: each thread issues the loads of its kRegionSpan rows before it
// tests any, the tile's hits are OR-ed per ray in shared memory, and a ray
// with a hit reads no further tile. The block leaves once every one of
// its rays is decided, so a kept ray reads at most the rest of the tile
// of its first live point in the box.
template <typename F>
__global__ void __launch_bounds__(kRegionRays * kRegionWarps)
    region_kernel(const RegionArgs<F> a) {
  __shared__ int hit[kRegionRays];
  const int lane = threadIdx.x % kRegionRays;
  const int warp = threadIdx.x / kRegionRays;
  const int i = blockIdx.x * kRegionRays + lane;
  if (warp == 0) hit[lane] = (i >= a.R || a.keep[i]) ? 1 : 0;
  __syncthreads();
  bool done = hit[lane] != 0;
  for (int tile = 0; tile < a.nt && !__syncthreads_and(done);
       tile += kRegionTile) {
    if (!done) {
      const int t0 = tile + warp * kRegionSpan;
      F lon[kRegionSpan], lat[kRegionSpan], amp[kRegionSpan];
#pragma unroll
      for (int j = 0; j < kRegionSpan; ++j) {
        if (t0 + j < a.nt) {
          const long long t = t0 + j;
          lon[j] = __ldg(a.lon + t * a.s_lon + i);
          lat[j] = __ldg(a.lat + t * a.s_lat + i);
          amp[j] = __ldg(a.amp + t * a.s_amp + i);
        }
      }
      bool any = false;
#pragma unroll
      for (int j = 0; j < kRegionSpan; ++j) {
        if (t0 + j < a.nt && in_box(a, lon[j], lat[j], amp[j])) any = true;
      }
      if (any) hit[lane] = 1;
    }
    __syncthreads();
    done = hit[lane] != 0;
  }
  if (warp == 0 && i < a.R && hit[lane]) a.keep[i] = true;
}

// points_kernel's persistent grid: the blocks the card keeps resident.
template <typename F>
int points_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, points_kernel<F>,
                                                  kFluxBlock, 0);
    grid = sms * blocks > 0 ? sms * blocks : 1;
  }
  return grid;
}

template <typename F>
int launch_flux(const FluxArgs<F>& a, cudaStream_t stream) {
  if (a.R <= 0) return cudaSuccess;
  constexpr bool kF32 = std::is_same<F, float>::value;
  const int cells = a.nlon_bins * a.nlat_bins;
  cudaError_t e = cudaMemsetAsync(a.n_kept, 0, sizeof(int), stream);
  if (e == cudaSuccess && kF32) {
    e = cudaMemsetAsync(a.acc, 0, sizeof(float4) * cells, stream);
  }
  if (e != cudaSuccess) return e;
  compact_kernel<F><<<(a.R + kFluxBlock - 1) / kFluxBlock, kFluxBlock, 0,
                      stream>>>(a);
  unwrap_kernel<F><<<(a.R + kTile - 1) / kTile, kFluxBlock, 0, stream>>>(a);
  if (a.nt > 0) {
    points_kernel<F><<<points_grid<F>(), kFluxBlock, 0, stream>>>(a);
  }
  if constexpr (kF32) {
    maps_kernel<<<(cells + kFluxBlock - 1) / kFluxBlock, kFluxBlock, 0,
                  stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename F>
int launch_region(const RegionArgs<F>& a, cudaStream_t stream) {
  if (a.R <= 0 || a.nt <= 0) return cudaSuccess;
  region_kernel<F><<<(a.R + kRegionRays - 1) / kRegionRays,
                     kRegionRays * kRegionWarps, 0, stream>>>(a);
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
      double mwn_max, int checks, int weight, void* rays, void* n_kept,      \
      void* ixs, void* acc, void* stream) {                                  \
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
    a.rays = static_cast<int*>(rays);                                        \
    a.n_kept = static_cast<int*>(n_kept);                                    \
    a.ixs = static_cast<int*>(ixs);                                          \
    a.acc = static_cast<float*>(acc);                                        \
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
