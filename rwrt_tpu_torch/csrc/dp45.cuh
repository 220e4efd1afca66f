// Dormand-Prince 5(4) arithmetic for one lane, shared by the dense kernels
// (dense_run.cu) and the exact kernels (exact_run.cu): the NaN-propagating
// max/min, the trial step's stages 2-6 and 5th-order proposal, the scaled
// error norm and the step-size factors. The tableau is solvers/rk45.py's
// DP_A, DP_B, DP_E; each expression follows the plain PyTorch versions
// there (_dp_trial, _error_norm, _exact_factors), so with -fmad=false the
// kernels round as they do.
//
// The tableau lives in local constexpr arrays of each function, so the
// unrolled loops index it at compile time (a namespace-scope host array is
// not readable in device code); double literals are rounded to T where
// used, as the JAX package's weakly typed constants are.
#pragma once

#include "ray_rhs.cuh"

namespace rwrt {
namespace dp45 {

constexpr double kSafety = 0.9;
constexpr double kMinFactor = 0.2;
constexpr double kMaxFactor = 10.0;
constexpr double kErrorExponent = -0.2;

// jnp.maximum / jnp.minimum: NaN-propagating (fmax/fmin are not).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (isnan(a) || isnan(b)) ? nan_value<T>() : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (isnan(a) || isnan(b)) ? nan_value<T>() : (a < b ? a : b);
}

// Stages 2-6 of a trial step of size hs from y, given the FSAL stage in
// k[0]: fills k[1..5] and the 5th-order proposal y_new. I is the
// evaluation's instance (ray_rhs.cuh).
template <typename T, class I = Lane>
__device__ __forceinline__ void trial(const Background<T>& bg, const T y[5],
                                      T hs, T k[7][5], T y_new[5]) {
  constexpr double kA[6][5] = {
      {0.0, 0.0, 0.0, 0.0, 0.0},
      {1.0 / 5, 0.0, 0.0, 0.0, 0.0},
      {3.0 / 40, 9.0 / 40, 0.0, 0.0, 0.0},
      {44.0 / 45, -56.0 / 15, 32.0 / 9, 0.0, 0.0},
      {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729, 0.0},
      {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176,
       -5103.0 / 18656},
  };
  constexpr double kB[6] = {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192,
                            -2187.0 / 6784, 11.0 / 84};
  bool e;
#pragma unroll
  for (int s = 1; s < 6; ++s) {
    T ys[5];
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      T acc = T(0);
      bool first = true;
#pragma unroll
      for (int j = 0; j < s; ++j) {
        if (kA[s][j] != 0.0) {
          T term = T(kA[s][j]) * k[j][v];
          acc = first ? term : acc + term;
          first = false;
        }
      }
      ys[v] = y[v] + hs * acc;
    }
    ray_rhs<T, I>(bg, ys, k[s], &e);
  }
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    T acc = T(kB[0]) * k[0][v];
#pragma unroll
    for (int j = 1; j < 6; ++j) acc = acc + T(kB[j]) * k[j][v];
    y_new[v] = y[v] + hs * acc;
  }
}

// sqrt(mean over the 5 rows of (err / scale)^2), err = hs * sum(E k) over
// the 7 stages, scale = atol + max(|y|, |y_new|) * rtol; squares summed in
// row order.
template <typename T>
__device__ __forceinline__ T error_norm(const T k[7][5], T hs, const T y[5],
                                        const T y_new[5], T atol, T rtol) {
  constexpr double kE[7] = {-71.0 / 57600,  0.0,         71.0 / 16695,
                            -71.0 / 1920,   17253.0 / 339200,
                            -22.0 / 525,    1.0 / 40};
  T sq = T(0);
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    T acc = T(kE[0]) * k[0][v];
#pragma unroll
    for (int j = 1; j < 7; ++j) acc = acc + T(kE[j]) * k[j][v];
    const T err = hs * acc;
    const T scale = atol + nan_max(fabs(y[v]), fabs(y_new[v])) * rtol;
    const T x = err / scale;
    sq = (v == 0) ? x * x : sq + x * x;
  }
  return sqrt(sq / T(5));
}

// The controller's factors on an accepted (fac_acc, at most 1 after a
// rejection in the same step) and a rejected (fac_rej) trial.
template <typename T>
__device__ __forceinline__ void step_factors(T error_norm, bool rejected,
                                             T* fac_acc, T* fac_rej) {
  const T raw = T(kSafety) * pow(error_norm, T(kErrorExponent));
  *fac_acc = nan_min(T(kMaxFactor), raw);
  if (rejected) *fac_acc = nan_min(T(1), *fac_acc);
  *fac_rej = nan_max(T(kMinFactor), raw);
}

}  // namespace dp45
}  // namespace rwrt
