// Dormand-Prince 5(4) arithmetic for one lane, shared by the dense kernels
// (dense_run.cu) and the exact kernels (exact_run.cu): the NaN-propagating
// max/min, the trial step's stages 2-6 and 5th-order proposal, the scaled
// error norm and the step-size factors. The tableau is solvers/rk45.py's
// DP_A, DP_B, DP_C, DP_E; each expression follows the plain PyTorch versions
// there (_dp_trial, _error_norm, _exact_factors), so with -fmad=false the
// kernels round as they do.
//
// The tableau lives in local constexpr arrays of each function, so the
// unrolled loops index it at compile time (a namespace-scope host array is
// not readable in device code); double literals are rounded to the type of
// the operand they meet, as the JAX package's weakly typed constants are.
//
// Types: S is the state's (y, t, h, the step products, the error norm and
// the controller), F the background's (the stages k and the sums of
// tableau coefficients times stages). In mixed precision (S double, F
// float) each stage sum is taken in F, widened and multiplied by the S
// step, and each stage input is rounded to F for the RHS, exactly where
// the JAX package's type promotion puts the casts; with S == F every cast
// is the identity.
//
// A team instance over a float64 state may spread the per-variable work
// over the team (kSpread, the whole-run exact kernel's): each of the
// team's first five threads takes one state variable's stage sums, trial
// state and error-norm term (Own: its stages and values), and shuffles give
// every thread the five results. Each value is computed by one thread with
// the expression the other instances use, and the error norm's squares are
// summed in row order, so the bits are the same; the FP64 pipes run each
// per-variable operation once for the team instead of eight times.
#pragma once

#include <type_traits>

#include "pow64.cuh"
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

// Whether the team instance I spreads the per-variable work of a state S
// (see the head of this file).
template <typename S, class I>
constexpr bool kSpreads = I::kThreads > 1 && std::is_same<S, double>::value;

// One state variable's share of a spread trial: its seven stages, its
// entry and 5th-order values.
template <typename S, typename F>
struct Own {
  F k[7];
  S y, y_new;
};

// Stage s's input of one row, y + hs * sum_j a_sj k_j (the sum in F, its
// zero coefficients skipped), rounded to F; k holds the row's stages.
template <typename S, typename F>
__device__ __forceinline__ F stage_input(int s, const F k[6], S y, S hs) {
  constexpr double kA[6][5] = {
      {0.0, 0.0, 0.0, 0.0, 0.0},
      {1.0 / 5, 0.0, 0.0, 0.0, 0.0},
      {3.0 / 40, 9.0 / 40, 0.0, 0.0, 0.0},
      {44.0 / 45, -56.0 / 15, 32.0 / 9, 0.0, 0.0},
      {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729, 0.0},
      {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176,
       -5103.0 / 18656},
  };
  F acc = F(0);
  bool first = true;
#pragma unroll
  for (int j = 0; j < s; ++j) {
    if (kA[s][j] != 0.0) {
      F term = F(kA[s][j]) * k[j];
      acc = first ? term : acc + term;
      first = false;
    }
  }
  return F(y + hs * S(acc));
}

// The 5th-order proposal of one row, y + hs * sum_j b_j k_j.
template <typename S, typename F>
__device__ __forceinline__ S proposal(const F k[6], S y, S hs) {
  constexpr double kB[6] = {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192,
                            -2187.0 / 6784, 11.0 / 84};
  F acc = F(kB[0]) * k[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) acc = acc + F(kB[j]) * k[j];
  return y + hs * S(acc);
}

// Stages 2-6 of a trial step of size hs from (t, y), given the FSAL stage
// in k[0]: fills k[1..5] and the 5th-order proposal y_new. Stage s samples
// at t + c_s hs, formed in S and rounded to F for the RHS (in a time
// instance; a static one forms no time). I is the evaluation's instance
// (ray_rhs.cuh). With kSpread (kSpreads<S, I>) each thread forms its own
// variable's stage inputs and proposal and keeps its stages and values in
// *own.
template <typename S, typename F, class I = Lane, bool kTime = false,
          bool kSpread = false>
__device__ __forceinline__ void trial(const Background<F, kTime>& bg,
                                      const S y[5], S t, S hs, F k[7][5],
                                      S y_new[5], Own<S, F>* own = nullptr) {
  static_assert(!kSpread || kSpreads<S, I>, "a team over a float64 state");
  constexpr double kC[6] = {0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0};
  if constexpr (kSpread) {
    own->y = I::template own<S, 5>(y);
    own->k[0] = I::template own<F, 5>(k[0]);
  }
  bool e;
#pragma unroll
  for (int s = 1; s < 6; ++s) {
    F ys[5];
    if constexpr (kSpread) {
      I::template share<F, 5>(stage_input(s, own->k, own->y, hs), ys);
    } else {
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        const F kv[6] = {k[0][v], k[1][v], k[2][v], k[3][v], k[4][v],
                         k[5][v]};
        ys[v] = stage_input(s, kv, y[v], hs);
      }
    }
    F ts = F(0);  // the stage's time (time instances only)
    if constexpr (kTime) ts = F(t + S(kC[s]) * hs);
    ray_rhs<F, I>(bg, ys, ts, k[s], &e);
    if constexpr (kSpread) own->k[s] = I::template own<F, 5>(k[s]);
  }
  if constexpr (kSpread) {
    own->y_new = proposal(own->k, own->y, hs);
    I::template share<S, 5>(own->y_new, y_new);
  } else {
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const F kv[6] = {k[0][v], k[1][v], k[2][v], k[3][v], k[4][v],
                       k[5][v]};
      y_new[v] = proposal(kv, y[v], hs);
    }
  }
}

// One row's scaled error err / scale: err = hs * sum(E k) over its 7
// stages (the sum in F), scale = atol + max(|y|, |y_new|) * rtol.
template <typename S, typename F>
__device__ __forceinline__ S scaled_error(const F k[7], S hs, S y, S y_new,
                                          S atol, S rtol) {
  constexpr double kE[7] = {-71.0 / 57600,  0.0,         71.0 / 16695,
                            -71.0 / 1920,   17253.0 / 339200,
                            -22.0 / 525,    1.0 / 40};
  F acc = F(kE[0]) * k[0];
#pragma unroll
  for (int j = 1; j < 7; ++j) acc = acc + F(kE[j]) * k[j];
  const S err = hs * S(acc);
  const S scale = atol + nan_max(fabs(y), fabs(y_new)) * rtol;
  return err / scale;
}

// sqrt(mean over the 5 rows of (err / scale)^2); squares summed in row
// order.
template <typename S, typename F>
__device__ __forceinline__ S error_norm(const F k[7][5], S hs, const S y[5],
                                        const S y_new[5], S atol, S rtol) {
  S sq = S(0);
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const F kv[7] = {k[0][v], k[1][v], k[2][v], k[3][v], k[4][v], k[5][v],
                     k[6][v]};
    const S x = scaled_error(kv, hs, y[v], y_new[v], atol, rtol);
    sq = (v == 0) ? x * x : sq + x * x;
  }
  return sqrt(sq / S(5));
}

// The same from a spread trial: each thread's own row's square, shared,
// then summed in row order.
template <typename S, typename F, class I>
__device__ __forceinline__ S error_norm(const Own<S, F>& own, S hs, S atol,
                                        S rtol) {
  const S x = scaled_error(own.k, hs, own.y, own.y_new, atol, rtol);
  S sq5[5];
  I::template share<S, 5>(x * x, sq5);
  S sq = sq5[0];
#pragma unroll
  for (int v = 1; v < 5; ++v) sq = sq + sq5[v];
  return sqrt(sq / S(5));
}

// The controller's factors on an accepted (fac_acc, at most 1 after a
// rejection in the same step) and a rejected (fac_rej) trial. In float64
// the pow is PyTorch's, inline (pow64.cuh).
template <typename T>
__device__ __forceinline__ void step_factors(T error_norm, bool rejected,
                                             T* fac_acc, T* fac_rej) {
  T p;
  if constexpr (std::is_same<T, double>::value) {
    p = pow64(error_norm, T(kErrorExponent));
  } else {
    p = pow(error_norm, T(kErrorExponent));
  }
  const T raw = T(kSafety) * p;
  *fac_acc = nan_min(T(kMaxFactor), raw);
  if (rejected) *fac_acc = nan_min(T(1), *fac_acc);
  *fac_rej = nan_max(T(kMinFactor), raw);
}

}  // namespace dp45
}  // namespace rwrt
