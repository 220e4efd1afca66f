"""The port's generic batched ODE solvers against the JAX package's.

tests/test_ode.py's problems (closed forms, the Lorenz system, a batch
with a failing lane, a tolerance ladder, the fixed-step RK4 with its
clamped last step, max_step) through ``rwrt_tpu.solvers.ode`` and
``rwrt_tpu_torch.solvers.ode`` on the same inputs, float64 on the CPU.

Bars: ys within 1e-12 of JAX's relative to their largest magnitude (NaN
masks identical); status, nfev and iters equal; RK4's step times equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwrt_tpu.solvers import ode as jode
from rwrt_tpu_torch.solvers import ode as pode

BAR = 1e-12


def quadratic(xp):
    return lambda t, y: xp.broadcast_to(2.0 * t, y.shape)


def decay(xp):
    return lambda t, y: -y


def lorenz(xp):
    def f(t, y):
        x, yy, z = y
        return xp.stack([10.0 * (yy - x), x * (28.0 - z) - yy,
                         x * yy - (8.0 / 3.0) * z])
    return f


def forced(xp):
    return lambda t, y: -0.5 * y + xp.sin(t)[None, :]


def blows_up(xp):
    return lambda t, y: xp.where(y > 3.0, math.nan, y)


def cosine(xp):
    return lambda t, y: xp.cos(t)[None, :] * y


#: name: (problem, y0, t_eval, keywords)
PROBLEMS = {
    "quadratic": (quadratic, np.zeros(1), np.linspace(0.5, 5.0, 10),
                  dict(rtol=1e-10, atol=1e-12)),
    "decay": (decay, np.ones(1), np.linspace(1, 4, 7),
              dict(rtol=1e-9, atol=1e-12)),
    "lorenz": (lorenz, np.ones(3), np.linspace(0.25, 2.0, 8),
               dict(rtol=1e-10, atol=1e-12)),
    "lorenz_batch": (lorenz, np.array([[1.0, -2.0, 0.5], [1.0, 0.3, 2.0],
                                       [1.0, 5.0, 10.0]]),
                     np.linspace(0.25, 1.0, 4), dict(rtol=1e-8, atol=1e-10)),
    "forced_batch": (forced, np.array([[1.0, -2.0, 0.3], [0.0, 1.0, -1.0]]),
                     np.linspace(0.5, 3.0, 6), dict(rtol=1e-8, atol=1e-10)),
    "failing_lane": (blows_up, np.array([[1.0, 1e-3]]),
                     np.linspace(0.5, 4.0, 8), dict(rtol=1e-9, atol=1e-12)),
    "loose": (cosine, np.ones((1, 1)), np.array([3.0]),
              dict(rtol=1e-4, atol=1e-14)),
    "tight": (cosine, np.ones((1, 1)), np.array([3.0]),
              dict(rtol=1e-10, atol=1e-14)),
    "max_step": (decay, np.ones((1, 2)), np.array([1.0, 2.0]),
                 dict(rtol=1e-3, atol=1e-6, max_step=0.05)),
    "max_iters": (lorenz, np.ones(3), np.array([1.0, 2.0]),
                  dict(rtol=1e-12, atol=1e-14, max_iters=20)),
    "first_step": (decay, np.ones((1, 3)), np.array([0.5, 1.0]),
                   dict(first_step=0.01, min_step=1e-4, t0=0.1)),
    "bad_start": (decay, np.array([[1.0, math.nan]]), np.array([1.0]), {}),
}


def close(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    scale = max(np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0,
                1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=BAR * scale,
                               equal_nan=True)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_solve_ivp_batched_matches_jax(name):
    problem, y0, t_eval, kw = PROBLEMS[name]
    want = jode.solve_ivp_batched(problem(jnp), jnp.asarray(y0), t_eval,
                                  **kw)
    got = pode.solve_ivp_batched(problem(torch), torch.as_tensor(y0),
                                 t_eval, **kw)
    close(want.ys, got.ys)
    np.testing.assert_array_equal(np.asarray(want.status),
                                  got.status.numpy())
    assert got.status.dtype == torch.int8
    assert int(got.nfev) == int(want.nfev)
    assert int(got.iters) == int(want.iters)


def test_batched_lanes_equal_solo_runs():
    """Lanes never couple: each lane of a batch equals its solo run."""
    problem, y0, t_eval, kw = PROBLEMS["forced_batch"]
    batched = pode.solve_ivp_batched(problem(torch), torch.as_tensor(y0),
                                     t_eval, **kw)
    for lane in range(y0.shape[1]):
        solo = pode.solve_ivp_batched(
            problem(torch), torch.as_tensor(y0[:, lane:lane + 1]), t_eval,
            **kw)
        torch.testing.assert_close(batched.ys[:, :, lane], solo.ys[:, :, 0],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("case", [dict(t_bound=1.0, dt=0.03),
                                  dict(t_bound=0.9, dt=0.1, t0=0.3),
                                  dict(t_bound=0.5, dt=0.5)],
                         ids=["clamped", "offset", "one_step"])
@pytest.mark.parametrize("squeeze", [False, True])
def test_solve_ivp_rk4_matches_jax(case, squeeze):
    y0 = np.array([1.0, 1.0, 1.0]) if squeeze else np.array(
        [[1.0, -1.0], [1.0, 0.5], [1.0, 3.0]])
    want_ys, want_ts = jode.solve_ivp_rk4(lorenz(jnp), jnp.asarray(y0),
                                          **case)
    got_ys, got_ts = pode.solve_ivp_rk4(lorenz(torch), torch.as_tensor(y0),
                                        **case)
    np.testing.assert_array_equal(np.asarray(want_ts), got_ts.numpy())
    close(want_ys, got_ys)


def test_max_step_validation():
    with pytest.raises(ValueError, match="max_step"):
        pode.solve_ivp_batched(decay(torch), torch.ones(1), [1.0],
                               max_step=0.0)
