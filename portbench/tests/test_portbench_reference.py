"""The plain reference against facts that need no program: the roots of
cubics as numpy finds them, and the basic state of solid-body rotation,
whose vorticity and Mercator beta are known in closed form."""

import math

import numpy as np
import torch

from portbench.reference import rays, state


def test_roots_are_numpys_real_roots_in_order():
    rng = np.random.default_rng(0)
    n = 500
    fu, fv = rng.uniform(-30, 60, n), rng.uniform(-10, 10, n)
    fqx, fqy = rng.uniform(-50, 50, n), rng.uniform(-50, 400, n)
    k = rng.integers(1, 8, n).astype(float)
    got = rays.roots(fu, fv, fqx, fqy, k, 0.0, np.float64)
    for i in range(n):
        want = np.roots([fv[i], k[i] * fu[i], k[i] ** 2 * fv[i] + fqx[i],
                         k[i] ** 3 * fu[i] - fqy[i] * k[i]])
        want = np.sort([w.real for w in want if abs(w.imag) < 1e-8
                        and abs(w.real) < 100])
        want = [w for w in want if w >= 0] + [w for w in want if w < 0][::-1]
        assert np.allclose(got[i, :len(want)], want, rtol=1e-10, atol=1e-10)
        assert np.isnan(got[i, len(want):]).all()


def test_a_vanishing_leading_coefficient_keeps_the_small_roots():
    # v -> 0 sends one root to infinity; the other two are the quadratic's.
    fu, fqx, fqy, k = 23.12, -0.011, 398.29, 4.0
    for fv in (-5e-3, -5e-9, 0.0):
        got = rays.roots([fu], [fv], [fqx], [fqy], [k], 0.0, np.float64)[0]
        want = np.roots([k * fu, k * k * fv + fqx, k ** 3 * fu - fqy * k])
        assert np.allclose(np.sort(got[:2]), np.sort(want.real), rtol=1e-3)
        assert np.isnan(got[2])


def test_solid_body_rotation_state():
    nlon, nlat, amp = 144, 73, 20.0
    lat = np.linspace(-math.pi / 2, math.pi / 2, nlat)
    u = np.broadcast_to(amp * np.cos(lat), (nlon, nlat))
    bs = state.prepare(u, np.zeros_like(u), torch.float64, "cpu")
    sin, cos = np.sin(lat[1:-1]), np.cos(lat[1:-1])
    q = (2 * amp + 2 * state.OMEGA * state.REARTH) * sin
    assert np.allclose(bs.q[0, 1:-1].numpy(), q, rtol=2e-3, atol=1e-9)
    # u = a cos: -cos u_yy + sin u_y + u / cos = a (cos^2 - sin^2 + 1),
    # so beta_M = (2 Omega + 2 a / R) cos^2 / R.
    bm = (2 * state.OMEGA + 2 * amp / state.REARTH) * cos ** 2 \
        / state.REARTH
    inner = slice(2, nlat - 4)
    assert np.allclose(bs.betam[0, 1:-1].numpy()[inner], bm[inner],
                       rtol=2e-3)
    assert torch.isnan(bs.betam[:, [0, -1]]).all()
    assert bs.fields.shape == (nlon + 1, nlat, 18)
    assert torch.equal(bs.fields[0], bs.fields[-1])
