"""Closed-form dispersion-relation roots: meridional wavenumbers m.

Port of ``rwrt_tpu/ops/cubic.py`` ``solve_dispersion_cubic``. The dispersion
relation for barotropic Rossby waves on the Mercator plane, with zwn = k*R
and ps = freq/zwn*R:

    fv*m^3 + zwn*(fu - ps)*m^2 + (zwn^2*fv + fqx)*m
        + zwn^3*(fu - ps - fqy/zwn^2) = 0

Semantics kept: window-aware degree demotion, Cardano / trigonometric
roots with two guarded Newton polishes, |Im| < delt counts a pair as real,
|m| >= 100 and zwn == 0 give no root, canonical slot order (non-negative
roots first, each group by ascending |m|, NaN last). ``fortran_slot_order``
is the reference's slot shuffle for root_order='fortran'.

The roots are differentiable in the coefficients by the implicit function
theorem, as the JAX package's custom JVP has them (``_Roots``): the closed
form's branch selects would otherwise carry 0 * NaN into the cotangents.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from rwrt_tpu_torch.constants import delt, mwn_cap, rearth
from rwrt_tpu_torch.ops.interp import lane_op


def _cbrt(x):
    return torch.sign(x) * lane_op(torch.pow, torch.abs(x), 1.0 / 3.0)


def _where(cond, a, b):
    """torch.where that accepts a Python scalar on one side."""
    ref = a if torch.is_tensor(a) else b
    if not torch.is_tensor(a):
        a = torch.full_like(ref, a)
    if not torch.is_tensor(b):
        b = torch.full_like(ref, b)
    return torch.where(cond, a, b)


def _solve_cubic_depressed(p, q):
    """Real roots of t^3 + p t + q = 0: (roots (3, ...), pair_real)."""
    half_q = 0.5 * q
    third_p = p / 3.0
    disc = half_q * half_q + third_p * third_p * third_p

    # Cardano branch (disc > 0): one real root + conjugate pair.
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = _cbrt(-half_q + sq)
    v = _cbrt(-half_q - sq)
    t0_card = u + v
    pair_re_card = -0.5 * (u + v)
    pair_im_card = (math.sqrt(3.0) / 2.0) * (u - v)

    # Trigonometric branch (disc < 0): three real roots.
    guard = 1e-300 if p.dtype == torch.float64 else 1e-30
    mp = torch.sqrt(torch.clamp(-third_p, min=guard))
    cos_arg = torch.clamp(-half_q / (mp * mp * mp), -1.0, 1.0)
    theta = torch.arccos(cos_arg) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    t0_trig = 2.0 * mp * torch.cos(theta)
    t1_trig = 2.0 * mp * torch.cos(theta - two_pi_3)
    t2_trig = 2.0 * mp * torch.cos(theta + two_pi_3)

    use_card = disc > 0.0
    r0 = torch.where(use_card, t0_card, t0_trig)
    r1 = torch.where(use_card, pair_re_card, t1_trig)
    r2 = torch.where(use_card, pair_re_card, t2_trig)
    pair_real = torch.where(use_card, torch.abs(pair_im_card) < delt,
                            torch.ones_like(use_card))
    return torch.stack([r0, r1, r2]), pair_real


def _roots_closed_form(c3, c2, c1, c0, nonzero_k) -> torch.Tensor:
    """Sorted NaN-padded real roots (..., 3) of c3 m^3 + c2 m^2 + c1 m + c0."""
    dtype = c3.dtype

    # Effective degree over the |m| < 100 root window: demote when the
    # leading coefficient's largest contribution over the window is below
    # tau of the largest one (closed-form Cardano is unstable for tiny c3).
    tau = 1e4 * torch.finfo(dtype).eps
    s3 = torch.abs(c3) * mwn_cap**3
    s2 = torch.abs(c2) * mwn_cap**2
    s1 = torch.abs(c1) * mwn_cap
    s0 = torch.abs(c0)
    smax = torch.maximum(torch.maximum(s3, s2), torch.maximum(s1, s0))
    thresh = tau * smax
    deg3 = s3 >= thresh
    deg2 = ~deg3 & (s2 >= thresh)
    deg1 = ~deg3 & ~deg2 & (s1 >= thresh)
    nontrivial = smax > 0.0
    deg3 &= nontrivial
    deg2 &= nontrivial
    deg1 &= nontrivial

    nan = float("nan")

    # Cubic: normalize to monic and depress.
    a = _where(deg3, c3, 1.0)
    b = c2 / a
    c = c1 / a
    d = c0 / a
    p = c - b * b / 3.0
    q = 2.0 * b**3 / 27.0 - b * c / 3.0 + d
    t_roots, pair_real = _solve_cubic_depressed(p, q)
    shift = b / 3.0

    def polish(m):
        # Two guarded Newton iterations on the monic cubic.
        for _ in range(2):
            pm = ((m + b) * m + c) * m + d
            dpm = (3.0 * m + 2.0 * b) * m + c
            step = pm / _where(dpm == 0.0, 1.0, dpm)
            m = m - _where(torch.abs(step) < 0.5, step, 0.0)
        return m

    cub0 = polish(t_roots[0] - shift)
    # Pair slots are polished only when they are genuine real roots (trig
    # branch); a treated-as-real tiny-Im pair keeps its common real part.
    genuine_pair = pair_real & torch.logical_not(
        (0.5 * q) ** 2 + (p / 3.0) ** 3 > 0.0
    )
    cub1 = _where(
        pair_real,
        torch.where(genuine_pair, polish(t_roots[1] - shift),
                    t_roots[1] - shift),
        nan,
    )
    cub2 = _where(
        pair_real,
        torch.where(genuine_pair, polish(t_roots[2] - shift),
                    t_roots[2] - shift),
        nan,
    )

    # Quadratic: c2 m^2 + c1 m + c0; pair real when |Im| < delt.
    a2 = _where(deg2, c2, 1.0)
    disc2 = c1 * c1 - 4.0 * a2 * c0
    sq2 = torch.sqrt(torch.abs(disc2))
    q_im = sq2 / (2.0 * torch.abs(a2))
    q_real = (disc2 >= 0.0) | (q_im < delt)
    qq = -0.5 * (c1 + torch.sign(c1 + (c1 == 0.0).to(dtype)) * sq2)
    qq_safe = _where(qq != 0.0, qq, 1.0)
    pair_re = -c1 / (2.0 * a2)
    quad0 = _where(
        q_real,
        torch.where(disc2 >= 0.0, _where(qq != 0.0, qq / a2, 0.0), pair_re),
        nan,
    )
    quad1 = _where(
        q_real,
        torch.where(disc2 >= 0.0, _where(qq != 0.0, c0 / qq_safe, 0.0),
                    pair_re),
        nan,
    )

    # Linear: c1 m + c0.
    lin0 = -c0 / _where(deg1, c1, 1.0)

    r0 = torch.where(deg3, cub0, torch.where(
        deg2, quad0, _where(deg1, lin0, nan)))
    r1 = torch.where(deg3, cub1, _where(deg2, quad1, nan))
    r2 = _where(deg3, cub2, nan)
    roots = torch.stack([r0, r1, r2], dim=-1)

    # Validity: finite, |m| < 100, zwn != 0.
    valid = (torch.isfinite(roots) & (torch.abs(roots) < mwn_cap)
             & nonzero_k[..., None])
    roots = _where(valid, roots, nan)

    # Canonical slot order: (negative?, |m|) ascending, NaN last; a stable
    # sort, as jnp.argsort is.
    key = _where(
        torch.isnan(roots), math.inf,
        torch.abs(roots) + (roots < 0).to(dtype) * 200.0,
    )
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.take_along_dim(roots, order, dim=-1)


class _Roots(torch.autograd.Function):
    """``_roots_closed_form`` with implicit-function-theorem gradients.

    P(m; c) = 0 gives dm = -(sum_k dc_k m^k) / P'(m), so the cotangent g of
    a root gives grad c_k = -sum over the slots of g m^k / P'(m). As in the
    JAX package's tangent rule: absent (NaN) roots are taken as 0 before any
    product and get exactly zero gradient, and P'(m) = 0 or NaN (a double
    root) divides by 1, so a zero cotangent never meets a NaN or an inf.
    """

    @staticmethod
    def forward(ctx, c3, c2, c1, c0, nonzero_k):
        m = _roots_closed_form(c3, c2, c1, c0, nonzero_k)
        ctx.save_for_backward(c3, c2, c1, m)
        return m

    @staticmethod
    def backward(ctx, g):
        c3, c2, c1, m = ctx.saved_tensors
        absent = torch.isnan(m)
        m_s = torch.where(absent, torch.zeros_like(m), m)
        den = (3.0 * c3[..., None] * m_s + 2.0 * c2[..., None]) * m_s \
            + c1[..., None]
        den = torch.where(torch.isnan(den) | (den == 0.0),
                          torch.ones_like(den), den)
        w = torch.where(absent, torch.zeros_like(m), -g / den)
        w1 = w * m_s
        w2 = w1 * m_s
        w3 = w2 * m_s
        return w3.sum(-1), w2.sum(-1), w1.sum(-1), w.sum(-1), None


def _roots_from_coeffs(c3, c2, c1, c0, nonzero_k) -> torch.Tensor:
    """Sorted NaN-padded real roots (..., 3) of c3 m^3 + c2 m^2 + c1 m + c0,
    differentiable in the coefficients (``_Roots``)."""
    return _Roots.apply(c3, c2, c1, c0, nonzero_k)


def solve_dispersion_cubic(fu, fv, fqx, fqy, freq,
                           zwn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Meridional-wavenumber roots at each point.

    Args:
      fu, fv, fqx, fqy: Mercator background samples (broadcastable).
      freq: wave frequency (Python scalar or tensor).
      zwn: dimensionless zonal wavenumber k*R (broadcastable).

    Returns:
      roots: (..., 3) real roots, NaN-padded, canonical order;
        differentiable in every argument (``_Roots``).
      count: (...) number of valid roots.
    """
    fu, fv, fqx, fqy, zwn = torch.broadcast_tensors(fu, fv, fqx, fqy, zwn)
    nonzero_k = zwn != 0.0
    kz = _where(nonzero_k, zwn, 1.0)
    ps = freq / kz * rearth

    c3 = fv
    c2 = kz * (fu - ps)
    c1 = kz * kz * fv + fqx
    c0 = kz**3 * (fu - ps) - fqy * kz

    roots = _roots_from_coeffs(c3, c2, c1, c0, nonzero_k)
    count = torch.sum(torch.logical_not(torch.isnan(roots)), dim=-1)
    return roots, count


def fortran_slot_order(mwn: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The Fortran-heritage slot shuffle (the reference's
    change_roots_order) applied to a (..., 3) root array with its per-point
    root count: the conditional swap sequences for 3, 2 and 1 roots, then
    the final slot reversal, as elementwise ``torch.where`` swaps.

    The reference applies it to whatever order its eigenvalue backend
    emitted, so slot parity with the reference needs np.roots' order
    (``ops.cubic_host.initial_roots_reference_order``).
    """
    m0, m1, m2 = mwn[..., 0], mwn[..., 1], mwn[..., 2]

    def swap(a, b, cond):
        return torch.where(cond, b, a), torch.where(cond, a, b)

    # Three roots.
    is3 = count == 3
    c = is3 & (m2 >= 0.0) & (m2 < m1)
    m1, m2 = swap(m1, m2, c)
    c = is3 & (m0 < 0.0)
    m0, m1 = swap(m0, m1, c)
    c = is3 & (((m1 < 0.0) & (m2 < 0.0) & (m1 < m2))
               | ((m1 > 0.0) & (m2 < 0.0)))
    m1, m2 = swap(m1, m2, c)

    # Two roots: only the loop's first iteration executes (both branches
    # break); swap slots 0 and 1 unless m0 is a finite positive root.
    is2 = count == 2
    c = is2 & ~(torch.isfinite(m0) & (m0 > 0.0))
    m0, m1 = swap(m0, m1, c)

    # One root: the literal i = 0, 1, 2 sweep.
    is1 = count == 1
    for i in range(3):
        mi = (m0, m1, m2)[i]
        c_pos = is1 & torch.isfinite(mi) & (mi >= 0.0) & (i != 0)
        c_neg = is1 & torch.isfinite(mi) & (mi <= 0.0) & (i != 2) & ~c_pos
        if i == 0:
            m0, m1 = swap(m0, m1, c_neg)
        elif i == 1:
            m1, m0 = swap(m1, m0, c_pos)
            # c_neg with i=1 swaps slot 1 with itself: no-op.
        else:
            m2, m0 = swap(m2, m0, c_pos)

    # Final reversal. The |m| >= 100 NaN filter is the caller's.
    return torch.stack([m2, m1, m0], dim=-1)
