"""Fixed-step RK4 ray integration.

Port of ``rwrt_tpu/solvers/rk4.py``, the plain PyTorch version: the JAX
``scan`` over output steps becomes a Python loop. Per-step semantics are the
JAX package's:

- a ray advances only if none of its four RK stages raised the RHS's fail
  flag (|lat| >= pi/2 or |ky| >= 100); otherwise it keeps its previous
  state. A NaN state raises no flag, so a rootless lane writes its NaN
  proposal and is NaN from step 1;
- after the update, rays whose new |lat| >= pi/2 or whose haversine move
  from the previous carry reaches cut_off are NaN-killed;
- (ug, vg) are re-derived at the new state (NaN propagating).

Step ``s`` of a run (or chunk) entered at ``t_start`` is taken at
t = t_start + s * dt in the state's dtype; its stages sample a
time-varying background at t, t + dt / 2 and t + dt, and (ug, vg) at
t + dt.

On the card the whole run is one launch of ``csrc/rk4_run.cu``
(``tracer._run_rk4``); this module is what that kernel is held against. It
calls the plain RHS (``models/ray._rhs_core``) on every device; a caller
of ``rk4_step`` may pass the dispatching ``ray.rhs`` instead. One step of
every lane from its own time, as ``diagnostics/termination.classify``'s
re-run takes it, is ``rk4_step_rays``: on a CUDA state one launch of
``csrc/rk4_run.cu``'s step kernel (``STEP_LAUNCHES`` counts them), on a
CPU state ``rk4_step``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rwrt_tpu_torch import kernels
from rwrt_tpu_torch.models import ray as ray_mod
from rwrt_tpu_torch.models.ray import Background, S_KX, S_KY, S_LAT, S_LON

#: Launches of the one-step kernel in this process.
STEP_LAUNCHES = 0


def step_factors(dt, dtype: torch.dtype) -> Tuple[float, float, float]:
    """(dt, 0.5 * dt, dt / 6.0), each rounded to the state's ``dtype``
    where the JAX expression rounds it (``dt`` a 0-d array of the state's
    dtype): the halving is exact, the division is IEEE in ``dtype``."""
    d = torch.tensor(float(dt), dtype=torch.float64).to(dtype)
    return float(d), float(0.5 * d), float(d / torch.tensor(6.0, dtype=dtype))


def rk4_step(bg: Background, y: torch.Tensor, dt, t=0.0,
             rhs=None) -> torch.Tensor:
    """One RK4 step with per-ray freeze semantics from time t (a 0-d or
    (R,) tensor of the state's dtype, or 0.0). y: (5, R) -> (5, R).

    ``rhs`` (bg, y, t) -> (dy, err) evaluates the stages: by default the
    plain ``ray._rhs_core`` on every device (what the RK4 kernel is held
    against); ``ray.rhs`` launches the RHS kernel on a CUDA state, whose
    values are the plain version's to the bit.

    In mixed precision (a float64 state over a float32 background) the
    stages k come out in the background's dtype and their sum
    k1 + 2 k2 + 2 k3 + k4 is taken there; each product with dt, 0.5 dt or
    dt / 6 (0-d arrays of the state's dtype in the JAX package) is taken in
    the state's dtype, so the stages are widened first. PyTorch would keep
    a Python scalar times a float32 tensor in float32."""
    dt, half, sixth = step_factors(dt, y.dtype)
    if rhs is None:
        def rhs(bg, yy, tt):
            dy, err, _, _ = ray_mod._rhs_core(bg, yy, tt, False)
            return dy, err

    def wide(k):
        return k.to(y.dtype)

    k1, m1 = rhs(bg, y, t)
    k2, m2 = rhs(bg, y + half * wide(k1), t + half)
    k3, m3 = rhs(bg, y + half * wide(k2), t + half)
    k4, m4 = rhs(bg, y + dt * wide(k3), t + dt)
    valid = ~(m1 | m2 | m3 | m4)
    y_prop = y + sixth * wide(k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return torch.where(valid[None, :], y_prop, y)


def rk4_step_rays(bg: Background, y: torch.Tensor, dt, t0=0.0,
                  instance=None) -> torch.Tensor:
    """One RK4 step of every lane of y (5, R) from its own time t0 (a
    scalar or (R,), in the state's dtype), freeze semantics as
    ``rk4_step``'s: the candidate state (5, R), with no kill test.

    On a CPU state ``rk4_step`` with the plain stages. On a CUDA state one
    launch of the step kernel (``rwrt_rk4_step``; ``rwrt_rk4_step_time``
    over a time-varying or ensemble background), bitwise ``rk4_step``'s
    result, in ``step_instance``'s instance unless ``instance`` (a key of
    ``kernels.INSTANCES``) is given. A float64 state over a float32
    background takes the mixed instance."""
    if not y.is_cuda:
        return rk4_step(bg, y, dt, t0)
    global STEP_LAUNCHES
    dev, dtype = y.device, y.dtype
    key = kernels.state_key(y, bg.fields)
    if y.ndim != 2 or y.shape[0] != 5:
        raise ValueError(f"y must be (5, R); got {tuple(y.shape)}")
    r = y.shape[1]
    y = y.contiguous()
    variant, bg_args = ray_mod.kernel_background(bg, dev, key[1], r)
    extra = ()
    if variant:
        t = torch.as_tensor(t0, dtype=dtype, device=dev)
        extra = (t.expand(r).contiguous(),)
    out = torch.empty_like(y)
    kernels.launch(
        f"rwrt_rk4_step{variant}", key, *bg_args, y, *extra, out, r,
        *step_factors(dt, dtype),
        kernels.instance_id(instance or step_instance(r, key, variant)),
        kernels.stream(dev))
    STEP_LAUNCHES += 1
    return out


def step_instance(r: int, dtype, variant: str = "") -> str:
    """The one-step kernel's instance for ``r`` lanes on the card
    (``dtype`` a torch dtype or a (state, field) pair, ``variant`` "" or
    "_time"): the team in ``kernels.RK4_STEP_TEAM_LANES``' window where it
    fits the card's resident count, else one thread per lane."""
    return kernels.choose_instance(
        r, kernels.resident("rk4_step", kernels.TEAM, dtype,
                            variant=variant),
        kernels.RK4_STEP_TEAM_LANES[variant])


def step_time(t_start, s: int, dt, dtype: torch.dtype, device):
    """t_start + s * dt with each operand and the product rounded to the
    state's ``dtype``, as the JAX scan forms it from its float step index:
    a 0-d tensor on ``device``."""
    def scalar(x):
        return torch.tensor(float(x), dtype=torch.float64).to(
            device=device, dtype=dtype)

    return scalar(t_start) + scalar(s) * scalar(dt)


def trace_into(bg: Background, y: torch.Tensor, dt, n_steps: int, cut_off,
               ys: torch.Tensor, ugs: torch.Tensor, vgs: torch.Tensor,
               row_offset: int = 0, t_start=0.0) -> torch.Tensor:
    """``n_steps`` output steps from carry ``y`` entered at time
    ``t_start``, each written at row ``row_offset + step`` of ys (rows, 5,
    R) and ugs, vgs (rows, R). Returns the carry after the last step."""
    dt = step_factors(dt, y.dtype)[0]
    for s in range(n_steps):
        t = step_time(t_start, s, dt, y.dtype, y.device)
        y_new = rk4_step(bg, y, dt, t)
        kill = ray_mod.kill_mask(y_new, y[S_LON], y[S_LAT], cut_off)
        y_new = torch.where(kill[None, :], torch.full_like(y_new, float("nan")),
                            y_new)
        ug, vg = ray_mod.group_velocity_at(
            bg, y_new[S_LON], y_new[S_LAT], y_new[S_KX], y_new[S_KY],
            t + dt)
        ys[row_offset + s], ugs[row_offset + s], vgs[row_offset + s] = (
            y_new, ug, vg)
        y = y_new
    return y


def trace(bg: Background, y0: torch.Tensor, dt, nt: int, cut_off, ug0=None,
          vg0=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integrate the ray batch for nt output steps.

    Args:
      bg: the background.
      y0: (5, R) initial state [lon, lat, kx, ky, amp].
      dt: time step in seconds.
      nt: total number of saved times (including t=0).
      cut_off: haversine displacement kill threshold in radians per step.
      ug0, vg0: initial group velocities; default: the zero-invalid
        group velocity at y0.

    Returns ys (nt, 5, R) with y0 in row 0, and ug, vg (nt, R) whose row 0
    uses the zero-invalid initialization semantics.
    """
    if ug0 is None or vg0 is None:
        ug0, vg0 = ray_mod.group_velocity_at(
            bg, y0[S_LON], y0[S_LAT], y0[S_KX], y0[S_KY], zero_invalid=True)
    r = y0.shape[1]
    ys = torch.empty((nt, 5, r), dtype=y0.dtype, device=y0.device)
    ugs = torch.empty((nt, r), dtype=y0.dtype, device=y0.device)
    vgs = torch.empty_like(ugs)
    ys[0], ugs[0], vgs[0] = y0, ug0, vg0
    trace_into(bg, y0, dt, nt - 1, cut_off, ys, ugs, vgs, row_offset=1)
    return ys, ugs, vgs
