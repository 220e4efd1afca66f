"""Port parity: end-to-end gradients (the autodiff slice).

The port's counterparts of ``tests/test_autodiff.py``'s four cases, each
against the JAX package's gradient on the same inputs (numpy, float64) and
against central differences of the port's own forward:

- d(final lat)/d(wind amplitude) through prepare -> make_background ->
  initialize -> 24 RK4 steps: JAX's gradient to 1e-9 relative (the two
  agree to ~3e-14 on this input; the bar leaves room for the two
  frameworks' different summation orders in the FD stencils' reductions),
  central differences to 1e-6 as JAX's test holds them;
- the roots' implicit-function gradient per coefficient on JAX's 64-lane
  batch with demoted and rootless lanes: the vector-Jacobian product equal
  to JAX's to 1e-12 relative (the same tangent rule, transposed by hand
  here and by JAX there), to central differences to 1e-5 (JAX's bar), and
  exactly zero on absent roots;
- d(final lat)/d(seed lat), over 24 steps where JAX's test takes 12 (one
  compiled JAX pass gives both gradients): JAX's to 1e-9, central
  differences to 1e-5 (JAX's bar);
- ``optimize_seeds``: after 3 Adam steps the positions and the history
  equal JAX's (optax's Adam) to 1e-9 (~5e-15 found), and the objective
  falls.

Also: a gradient-carrying input makes every kernel launch raise before
the library is loaded, and ``prepare`` keeps a tensor wind's graph. No
gradient here is NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.diagnostics import targeting as jtargeting
from rwrt_tpu.ops import cubic as jcubic
from rwrt_tpu.solvers import rk4 as jrk4
from rwrt_tpu_torch import kernels, tracer
from rwrt_tpu_torch.diagnostics import targeting
from rwrt_tpu_torch.ops import cubic
from rwrt_tpu_torch.solvers import rk4

JAX_BAR = 1e-9
SEED = ([0.3], [0.25], [4.0])


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


def final_lat_torch(field, amp, slat=0.25, nt=25):
    """The latitude of the seed's first root's ray after nt - 1 RK4
    steps."""
    u, v, lat, lon = field
    bs = pt.prepare(amp * torch.as_tensor(u), torch.as_tensor(v), lat, lon,
                    read_dtype="float64", cal_dtype="float64", device="cpu")
    bg = tracer.make_background(bs, 0.0)
    y0, _, _ = tracer.initialize(bg, _t(SEED[0]), slat.reshape(1)
                                 if torch.is_tensor(slat) else _t([slat]),
                                 _t(SEED[2]))
    ys, _, _ = rk4.trace(bg, y0, 7200.0, nt, 0.2)
    return ys[-1, 1, 0]


def final_lat_jax(field, amp, slat=0.25, nt=25):
    """``final_lat_torch`` through the JAX package."""
    u, v, lat, lon = field
    bs = rt.prepare(amp * jnp.asarray(u), jnp.asarray(v), lat, lon,
                    read_dtype="float64", cal_dtype="float64")
    bg = jtracer.make_background(bs, 0.0)
    y0, _, _ = jtracer.initialize(bg, jnp.asarray(SEED[0]),
                                  jnp.reshape(slat, (1,)),
                                  jnp.asarray(SEED[2]))
    ys, _, _ = jrk4.trace(bg, y0, 7200.0, nt, jnp.asarray(0.2))
    return ys[-1, 1, 0]


@pytest.fixture(scope="module")
def field(jet_field):
    u, v, lat, lon = jet_field
    return np.asarray(u), np.asarray(v), lat, lon


@pytest.fixture(scope="module")
def jax_grads(field):
    """The JAX package's gradients d/d(amp) and d/d(seed lat) over 24
    steps, from one compiled reverse pass."""
    g = jax.jit(jax.grad(lambda a, s: final_lat_jax(field, a, s),
                         argnums=(0, 1)))(1.0, 0.25)
    return float(g[0]), float(g[1])


def test_grad_through_full_pipeline(field, jax_grads):
    amp = _t(1.0).requires_grad_(True)
    out = final_lat_torch(field, amp)
    out.backward()
    g = float(amp.grad)
    assert np.isfinite(g)
    assert abs(g - jax_grads[0]) <= JAX_BAR * abs(jax_grads[0])
    eps = 1e-6
    with torch.no_grad():
        fd = float(final_lat_torch(field, _t(1.0 + eps))
                   - final_lat_torch(field, _t(1.0 - eps))) / (2 * eps)
    assert abs(g - fd) <= 1e-6 * max(1.0, abs(fd))


def test_grad_wrt_source_position(field, jax_grads):
    slat = _t(0.25).requires_grad_(True)
    out = final_lat_torch(field, 1.0, slat)
    (g,) = torch.autograd.grad(out, slat)
    g = float(g)
    assert np.isfinite(g)
    assert abs(g - jax_grads[1]) <= JAX_BAR * abs(jax_grads[1])
    eps = 1e-6
    with torch.no_grad():
        fd = float(final_lat_torch(field, 1.0, 0.25 + eps)
                   - final_lat_torch(field, 1.0, 0.25 - eps)) / (2 * eps)
    assert abs(g - fd) <= 1e-5 * max(1.0, abs(fd))


def root_batch():
    """JAX's 64-lane batch: some lanes demoted to the quadratic (fv = 0),
    some rootless; its coefficients as solve_dispersion_cubic forms them
    (zwn 4, freq 0)."""
    rng = np.random.default_rng(7)
    n = 64
    fu = rng.normal(15.0, 12.0, n)
    fv = np.where(rng.random(n) < 0.25, 0.0, rng.normal(0.0, 4.0, n))
    fqx = rng.normal(0.0, 1.0, n)
    fqy = rng.normal(2.0, 1.0, n)
    k = 4.0
    return (fv, k * fu, k * k * fv + fqx, k**3 * fu - fqy * k), rng


def test_root_gradient_per_coefficient():
    coeffs, rng = root_batch()
    nonzero = np.ones(coeffs[0].shape, bool)
    g = rng.normal(size=coeffs[0].shape + (3,))

    m_j, vjp = jax.vjp(lambda *c: jcubic._roots_from_coeffs(
        *c, jnp.asarray(nonzero)), *(jnp.asarray(c) for c in coeffs))
    want = vjp(jnp.asarray(np.where(np.isnan(np.asarray(m_j)), 0.0, g)))

    ct = [_t(c).requires_grad_(True) for c in coeffs]
    m = cubic._roots_from_coeffs(*ct, torch.as_tensor(nonzero))
    np.testing.assert_array_equal(np.asarray(m_j), m.detach().numpy())
    absent = torch.isnan(m)
    assert absent.any() and (~absent).sum() > 30
    # The cotangent on the absent slots is NaN here: it must not leak.
    gt = torch.where(absent, torch.full_like(m, float("nan")), _t(g))
    got = torch.autograd.grad(m, ct, gt, retain_graph=True)
    for k, (a, b) in enumerate(zip(want, got)):
        b = b.numpy()
        assert np.isfinite(b).all(), k
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(a)).max(),
                                   err_msg=f"d/dc{3 - k}")

    # Against central differences of the closed form, per coefficient;
    # where a root exists on both sides of the stencil.
    eps = 1e-7
    for k in range(4):
        dc = [np.zeros_like(c) for c in coeffs]
        dc[k] = np.abs(coeffs[k]) * eps + eps
        with torch.no_grad():
            hi = cubic._roots_from_coeffs(
                *(_t(c + d) for c, d in zip(coeffs, dc)),
                torch.as_tensor(nonzero)).numpy()
            lo = cubic._roots_from_coeffs(
                *(_t(c - d) for c, d in zip(coeffs, dc)),
                torch.as_tensor(nonzero)).numpy()
        fd = (hi - lo) / (2 * dc[k][:, None])
        one_hot = torch.zeros(3, dtype=torch.float64)
        for slot in range(3):
            one_hot.zero_()
            one_hot[slot] = 1.0
            (gk,) = torch.autograd.grad(
                m, ct[k], one_hot.expand_as(m).contiguous(),
                retain_graph=True)
            ok = np.isfinite(fd[:, slot]) & ~absent[:, slot].numpy()
            np.testing.assert_allclose(gk.numpy()[ok], fd[ok, slot],
                                       rtol=1e-5, atol=1e-8,
                                       err_msg=f"c{3 - k} slot {slot}")
    # Absent roots carry exactly zero gradient to every coefficient.
    for gk in torch.autograd.grad(m, ct, absent.to(torch.float64)):
        assert (gk == 0.0).all()


def test_root_jvp_through_the_solve_matches_fd():
    """JAX's own case: d(roots)/d(scale of fu) through
    solve_dispersion_cubic, against central differences (1e-5, JAX's
    bar); absent roots exactly zero."""
    rng = np.random.default_rng(7)
    n = 64
    fu = _t(rng.normal(15.0, 12.0, n))
    fv = _t(np.where(rng.random(n) < 0.25, 0.0, rng.normal(0.0, 4.0, n)))
    fqx = _t(rng.normal(0.0, 1.0, n))
    fqy = _t(rng.normal(2.0, 1.0, n))
    zwn = torch.full((n,), 4.0, dtype=torch.float64)

    def roots_of(s):
        return cubic.solve_dispersion_cubic(fu * s, fv, fqx, fqy, 0.0,
                                            zwn)[0]

    eps = 1e-7
    with torch.no_grad():
        r0 = roots_of(_t(1.0)).numpy()
        fd = ((roots_of(_t(1.0 + eps)) - roots_of(_t(1.0 - eps)))
              / (2 * eps)).numpy()
    # fu enters each lane alone, so a scale per lane gives every lane's
    # derivative in one backward pass per slot.
    sv = torch.ones(n, dtype=torch.float64, requires_grad=True)
    m = roots_of(sv)
    d = np.stack([torch.autograd.grad(m[:, k].sum(), sv,
                                      retain_graph=True)[0].numpy()
                  for k in range(3)], axis=1)
    ok = np.isfinite(fd) & np.isfinite(r0)
    assert ok.sum() > 30
    np.testing.assert_allclose(d[ok], fd[ok], rtol=1e-5, atol=1e-8)
    assert np.all(d[~np.isfinite(r0)] == 0.0)


@pytest.fixture(scope="module")
def targeting_case():
    """JAX's targeting case (a solid-body jet on 96 x 49, two seeds at
    zwn 4, the target at 120E 35N), over 24 steps."""
    nlon, nlat = 96, 49
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = 30.0 * np.cos(lat)[None, :] * np.ones((nlon, 1))
    v = np.zeros((nlon, nlat))
    args = (np.radians([10.0, 20.0]), np.radians([5.0, 8.0]), (4.0,),
            np.radians(120.0), np.radians(35.0))
    kw = dict(nt=25, steps=3, learning_rate=0.03)
    want = jtargeting.optimize_seeds(
        rt.prepare(u, v, lat, lon, cal_dtype="float64"), *args, **kw)
    return (u, v, lat, lon), args, kw, want


def test_optimize_seeds_matches_jax(targeting_case):
    (u, v, lat, lon), args, kw, want = targeting_case
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    got = targeting.optimize_seeds(bs, *args, **kw)
    for name in ("source_lon", "source_lat", "miss"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=JAX_BAR, err_msg=name)
    assert got.history.shape == (kw["steps"] + 1,)
    np.testing.assert_allclose(got.history, np.asarray(want.history),
                               rtol=0, atol=JAX_BAR)
    assert got.history[-1] < got.history[0]
    assert np.all(np.diff(got.history) < 0)
    assert not got.source_lat.requires_grad


def test_optimize_seeds_refuses_a_time_varying_state(targeting_case):
    (u, v, lat, lon), args, kw, _ = targeting_case
    bs = pt.prepare_time_varying(np.stack([u, u]), np.stack([v, v]), lat,
                                 lon, bg_dt=86400.0, cal_dtype="float64",
                                 device="cpu")
    with pytest.raises(ValueError, match="static background"):
        targeting.optimize_seeds(bs, *args, **kw)


def test_optimize_seeds_exported():
    from rwrt_tpu_torch import diagnostics

    assert diagnostics.optimize_seeds is targeting.optimize_seeds
    assert pt.optimize_seeds is targeting.optimize_seeds


def test_prepare_keeps_a_tensor_winds_graph(field):
    u, v, lat, lon = field
    ut = torch.as_tensor(u).requires_grad_(True)
    bs = pt.prepare(ut, torch.as_tensor(v), lat, lon, read_dtype="float64",
                    cal_dtype="float64", device="cpu")
    assert bs.fields.requires_grad
    (g,) = torch.autograd.grad(bs.fields[..., 0].sum() + bs.ks.nan_to_num(
        0.0).sum(), ut)
    assert torch.isfinite(g).all() and (g != 0).any()
    # The numpy route is the same state, bitwise.
    ref = pt.prepare(u, v, lat, lon, read_dtype="float64",
                     cal_dtype="float64", device="cpu")
    for a, b in zip(bs, ref):
        if torch.is_tensor(a):
            assert torch.equal(a.detach().nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("name", ["rwrt_rhs", "rwrt_rk4_run",
                                  "rwrt_gather"])
def test_kernel_launch_refuses_grad(name, monkeypatch):
    """Before the library loads (none can here): a tensor that requires
    grad under grad mode raises; under no_grad, or detached, the launch
    goes on to the library."""
    loaded = []
    monkeypatch.setattr(kernels, "library",
                        lambda: loaded.append(1) or (_ for _ in ()).throw(
                            LookupError("library")))
    x = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="plain, differentiable route"):
        kernels.launch(name, torch.float32, x, 4, None)
    assert not loaded
    with torch.no_grad():
        with pytest.raises(LookupError):
            kernels.launch(name, torch.float32, x, 4, None)
    with pytest.raises(LookupError):
        kernels.launch(name, torch.float32, x.detach(), 4, None)
    assert len(loaded) == 2


def test_trace_rays_refuses_grad_on_the_card_route(field, monkeypatch):
    """``trace_rays`` over a state whose fields carry a graph reaches the
    guard at its first launch: rehearsed on the CPU with the CUDA dispatch
    forced (the kernel wrappers take a CPU tensor for a card's)."""
    u, v, lat, lon = field
    ut = torch.as_tensor(u).requires_grad_(True)
    bs = pt.prepare(ut, torch.as_tensor(v), lat, lon, read_dtype="float64",
                    cal_dtype="float64", device="cpu")
    monkeypatch.setattr(tracer, "_run_rk4", tracer._run_rk4_cuda)
    monkeypatch.setattr(tracer, "rk4_instance", lambda *a: "lane")
    monkeypatch.setattr(kernels, "stream", lambda device: 0)
    cfg = pt.RunConfig(nnx=2, nny=2, ttotal=4 * 7200.0,
                       cal_dtype="float64")
    with pytest.raises(RuntimeError, match="plain, differentiable route"):
        pt.trace_rays(bs, cfg)
