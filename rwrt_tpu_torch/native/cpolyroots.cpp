// Host-side general complex polynomial root solver (Aberth-Ehrlich method).
//
// A copy of rwrt_tpu/native/cpolyroots.cpp, kept in the PyTorch port so the
// port never imports the JAX package. The device path uses the closed-form
// cubic in rwrt_tpu_torch/ops/cubic.py; this solver exists for host-side
// verification and for arbitrary-degree polynomials (degree > 3) that the
// analytic path does not cover. Exposed through ctypes
// (rwrt_tpu_torch/ops/cubic_host.py), which falls back to numpy with a
// one-time warning when the shared object cannot be built.
//
// Build: g++ -O3 -shared -fPIC -o libcpolyroots.so cpolyroots.cpp
// (done at first use by rwrt_tpu_torch/native/build.py, into
// rwrt_tpu_torch/_build/).

#include <complex>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

using cplx = std::complex<double>;

// Evaluate p(z) and p'(z) by Horner's scheme; coeffs highest-degree first.
inline void horner(const std::vector<cplx>& c, cplx z, cplx& p, cplx& dp) {
  p = c[0];
  dp = cplx(0.0, 0.0);
  for (size_t i = 1; i < c.size(); ++i) {
    dp = dp * z + p;
    p = p * z + c[i];
  }
}

}  // namespace

extern "C" {

// Find all roots of the degree-n polynomial with coefficients
// (coef_re, coef_im)[0..n] ordered highest-degree first.
// Returns 0 on success, nonzero on failure (degenerate input / no
// convergence). Roots are written to (root_re, root_im)[0..n-1].
int cpoly_roots(int degree, const double* coef_re, const double* coef_im,
                double* root_re, double* root_im,
                int max_iter, double tol) {
  if (degree < 1) return 1;
  std::vector<cplx> c(degree + 1);
  for (int i = 0; i <= degree; ++i) c[i] = cplx(coef_re[i], coef_im[i]);
  if (std::abs(c[0]) == 0.0) return 2;  // leading coefficient must be nonzero

  // Initial guesses: points on a circle sized by the Cauchy bound, slightly
  // de-symmetrized so the iteration does not stall on symmetric clusters.
  double bound = 0.0;
  for (int i = 1; i <= degree; ++i) {
    bound = std::max(bound, std::abs(c[i] / c[0]));
  }
  double radius = 1.0 + bound;
  std::vector<cplx> z(degree);
  const double kTwoPi = 6.28318530717958647692;
  for (int i = 0; i < degree; ++i) {
    double ang = kTwoPi * i / degree + 0.4;
    z[i] = 0.5 * radius * cplx(std::cos(ang), std::sin(ang));
  }

  // Aberth-Ehrlich simultaneous iteration.
  bool converged = false;
  for (int it = 0; it < max_iter; ++it) {
    double max_step = 0.0;
    for (int i = 0; i < degree; ++i) {
      cplx p, dp;
      horner(c, z[i], p, dp);
      cplx newton = (std::abs(dp) > 0.0) ? p / dp : cplx(tol, 0.0);
      cplx repulse(0.0, 0.0);
      for (int j = 0; j < degree; ++j) {
        if (j == i) continue;
        cplx d = z[i] - z[j];
        if (std::abs(d) > 1e-300) repulse += cplx(1.0, 0.0) / d;
      }
      cplx denom = cplx(1.0, 0.0) - newton * repulse;
      cplx step = (std::abs(denom) > 1e-300) ? newton / denom : newton;
      z[i] -= step;
      max_step = std::max(max_step, std::abs(step));
    }
    if (max_step < tol * (1.0 + radius)) {
      converged = true;
      break;
    }
  }
  if (!converged) return 3;  // out of iterations: roots are not trustworthy

  // One Newton polish per root.
  for (int i = 0; i < degree; ++i) {
    for (int k = 0; k < 3; ++k) {
      cplx p, dp;
      horner(c, z[i], p, dp);
      if (std::abs(dp) == 0.0) break;
      z[i] -= p / dp;
    }
    root_re[i] = z[i].real();
    root_im[i] = z[i].imag();
  }
  return 0;
}

// Batched variant: solve `count` independent polynomials of the same degree.
// Coefficient arrays are (count, degree+1) row-major; roots (count, degree).
int cpoly_roots_batch(int count, int degree,
                      const double* coef_re, const double* coef_im,
                      double* root_re, double* root_im,
                      int max_iter, double tol) {
  int status = 0;
  int stride_c = degree + 1;
  for (int b = 0; b < count; ++b) {
    int rc = cpoly_roots(degree, coef_re + b * stride_c,
                         coef_im + b * stride_c,
                         root_re + b * degree, root_im + b * degree,
                         max_iter, tol);
    if (rc != 0) {
      for (int i = 0; i < degree; ++i) {
        root_re[b * degree + i] = std::nan("");
        root_im[b * degree + i] = std::nan("");
      }
      status = rc;
    }
  }
  return status;
}

}  // extern "C"
