"""Ray ODE right-hand side and termination physics.

Port of ``rwrt_tpu/models/ray.py``. State layout: 5 prognostic variables per
ray stacked as a (5, R) tensor [lon, lat, kx, ky, amp]; dead rays are NaN
lanes, never control flow.

The RHS is one of the port's hand-written kernels (``csrc/ray_rhs.cuh``,
launched by ``csrc/rhs.cu``). ``rhs`` and ``rhs_and_gv`` dispatch on the
state's device: a CPU tensor runs the plain PyTorch version ``_rhs_core``; a
CUDA tensor launches the kernel (or raises). ``LAUNCHES`` counts kernel
launches.

Backgrounds may vary in time (a (T, W, H, 48) frame stack, lerped per lane
at the lane's time) and over ensemble members ((M, W, H, 48) or
(M, T, W, H, 48) stacks with a lane -> member map): ``sample_bg`` takes
the JAX package's branches, and the kernels take such a background through
their time instances (``kernel_background``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rwrt_tpu_torch import kernels
from rwrt_tpu_torch.constants import mwn_cap, pi, polar_cos_cap, rearth
from rwrt_tpu_torch.ops import groupvel as groupvel_mod
from rwrt_tpu_torch.ops import interp
from rwrt_tpu_torch.ops.groupvel import group_velocity

# State variable indices.
S_LON, S_LAT, S_KX, S_KY, S_AMP = range(5)
NUM_VARS = 5

#: Number of RHS kernel launches in this process.
LAUNCHES = 0


class Background(NamedTuple):
    """Per-run inputs to the RHS.

    fields: (nlon_wrap, nlat, 4 * NUM_HOT) corner-packed hot stack (see
        tracer.make_background), or an unpacked (nlon_wrap, nlat, C) stack.
    lon0, lat0: grid origin in radians; dx, dy: grid spacing in radians;
        freq: wave frequency (rad/s). Python floats already rounded to the
        fields' dtype, so the plain version and the kernel see one value.
    bg_t0, bg_dt: model time (s) of frame 0 and the frame spacing of a
        time-varying stack, rounded to the fields' dtype.
    member_ids: None, or the (R,) int32 lane -> member map of an ensemble
        (fields then (M, W, H, 48), or (M, T, W, H, 48) for time-varying
        members).

    The stacks are told apart as the JAX package tells them: a 4-D stack
    without member_ids is time-varying; with them, one stack per member.
    """

    fields: torch.Tensor
    lon0: float
    lat0: float
    dx: float
    dy: float
    freq: float
    bg_t0: float = 0.0
    bg_dt: float = 1.0
    member_ids: Optional[torch.Tensor] = None


def _tfrac(bg: Background, t, lon: torch.Tensor) -> torch.Tensor:
    """The fractional frame index (t - bg_t0) / bg_dt per lane, in lon's
    dtype: a Python time in the fields' dtype, a tensor one in its dtype
    promoted with the fields', as the JAX package's promotion has it. The
    division is ``interp.true_div``'s, so the kernels give the same bits."""
    fdt = bg.fields.dtype
    if torch.is_tensor(t):
        t = t.to(device=lon.device,
                 dtype=torch.promote_types(t.dtype, fdt))
    else:
        t = torch.full((), float(t), dtype=fdt, device=lon.device)
    tf = interp.true_div(t - bg.bg_t0, bg.bg_dt)
    return tf.to(lon.dtype).expand(lon.shape)


def sample_bg(bg: Background, lon, lat, t=0.0):
    """Sample the (possibly time-varying, possibly ensemble) Mercator
    background at positions and time t (a scalar or per lane); returns
    (C, R).

    Packed (4 * NUM_HOT channels) and unpacked static and time-varying
    stacks are accepted; ensemble stacks are packed. member_ids shorter than
    the positions (a call over flattened (k * R,) positions) is tiled.
    """
    packed = bg.fields.shape[-1] == 4 * interp.NUM_HOT
    if bg.member_ids is not None:
        member = bg.member_ids.to(lon.device)
        if member.shape[0] != lon.shape[0]:
            member = member.repeat(lon.shape[0] // member.shape[0])
        if bg.fields.ndim == 5:
            raw = interp.sample_raw_packed_member_time(
                bg.fields, bg.lon0, bg.lat0, bg.dx, bg.dy, lon, lat, member,
                _tfrac(bg, t, lon))
        else:
            raw = interp.sample_raw_packed_member(
                bg.fields, bg.lon0, bg.lat0, bg.dx, bg.dy, lon, lat, member)
        return interp.mercator_transform(raw, lat)
    if bg.fields.ndim == 4:
        tfrac = _tfrac(bg, t, lon)
        if packed:
            raw = interp.sample_raw_packed_time(
                bg.fields, bg.lon0, bg.lat0, bg.dx, bg.dy, lon, lat, tfrac)
            return interp.mercator_transform(raw, lat)
        return interp.sample_mercator_time(
            bg.fields, bg.lon0, bg.lat0, bg.dx, bg.dy, lon, lat, tfrac)
    if packed:
        return interp.sample_mercator_packed(
            bg.fields, bg.lon0, bg.lat0, bg.dx, bg.dy, lon, lat)
    return interp.sample_mercator(
        bg.fields, bg.lon0, bg.lat0, bg.dx, bg.dy, lon, lat)


def _sample_sanitized(bg: Background, lon, lat, t, dead):
    """``sample_bg`` at (lon, lat), computed from finite positions only:
    lanes ``dead`` (a NaN position) sample cell (0, 0), and lanes outside
    the latitude band (|lat| > pi/2) sample at lat 0 and then take what
    their own sample holds, NaN, or 0 where |cos lat| <= polar_cos_cap
    (``interp.mercator_transform`` zeroes the cap). Equal to sampling at
    the sanitized positions; in reverse mode no zero cotangent of such a
    lane meets the NaN of an out-of-band sample."""
    zero = torch.zeros_like(lat)
    oob = (torch.abs(lat) > 0.5 * pi) & ~dead
    f = sample_bg(bg, torch.where(dead, zero, lon),
                  torch.where(dead | oob, zero, lat), t)
    cap = torch.abs(torch.cos(lat)) <= polar_cos_cap
    fill = torch.where(cap, zero, torch.full_like(lat, float("nan")))
    return torch.where(oob, fill, f)


def timed(bg: Background) -> bool:
    """Whether a sample of ``bg`` depends on time: a 4-D stack without
    member_ids, a 5-D one with them (``kernel_background``'s rule)."""
    return bg.fields.ndim == (4 if bg.member_ids is None else 5)


def kernel_background(bg: Background, device, dtype, lanes: int):
    """The background as a kernel launch takes it: (variant, args).

    A static corner-packed (W, H, 48) stack gives ("", (fields, W, H, lon0,
    lat0, dx, dy)), the arguments of the static entry points. A
    time-varying or ensemble stack gives ("_time", the same followed by
    (nt, timed, t0, dt, member_ids)), the arguments of the entry points of
    the time instances (``<name>_time``): nt frames a member, whether to
    lerp in time (every 4-D stack without member_ids and every 5-D stack;
    a member's static stack is one frame, read without a blend), and the
    (lanes,) int32 member map or None. Raises unless the stack is on
    ``device`` in ``dtype``, contiguous and 16-byte aligned.
    """
    packed = bg.fields
    kernels.check_tensor(packed, "fields", device=device, dtype=dtype)
    kernels.check_aligned(packed, "fields")
    member = bg.member_ids
    shape_ok = packed.shape[-1] == 4 * interp.NUM_HOT and (
        packed.ndim in (3, 4) if member is None else packed.ndim in (4, 5))
    if not shape_ok:
        raise ValueError(
            "the kernels need a corner-packed background "
            "(tracer.make_background): (W, H, 48), (T, W, H, 48), or with "
            "member_ids (M, W, H, 48) or (M, T, W, H, 48); got "
            f"{tuple(packed.shape)}"
            + (" with member_ids" if member is not None else ""))
    w, h = packed.shape[-3], packed.shape[-2]
    args = (packed, w, h, bg.lon0, bg.lat0, bg.dx, bg.dy)
    if packed.ndim == 3:
        return "", args
    if member is not None:
        kernels.check_tensor(member, "member_ids", device=device,
                             dtype=torch.int32, shape=(lanes,))
    lerp = timed(bg)
    nt = packed.shape[-4] if lerp else 1
    return "_time", args + (nt, int(lerp), bg.bg_t0, bg.bg_dt, member)


def fail_mask(y: torch.Tensor) -> torch.Tensor:
    """True where |lat| >= pi/2 or |ky| >= 100; NaN states compare False."""
    return (torch.abs(y[S_LAT]) >= 0.5 * pi) | (torch.abs(y[S_KY]) >= mwn_cap)


def rhs(bg: Background, y: torch.Tensor,
        t=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """dy/dt for the ray batch: (dy (5, R), err (R,) bool).

      dlon/dt = ug / R
      dlat/dt = vg cos(lat) / R
      dk/dt   = -k [(fmux + kap fmvx) + (kap fmqxx - fmqyx)/K^2] / R
      dl/dt   = -k [(fmuy + kap fmvy) + (kap fmqxy - fmqyy)/K^2] / R
      damp/dt = amp [2(fmux + fmvy + kap(fmvx + fmuy))/(1+kap^2)
                     + 2(kap(fmqxx - fmqyy) + (kap^2-1) fmqxy)/(K^2(1+kap^2))
                     - 2 sin(lat) fmv] / R

    err flags rays whose derivatives were forced NaN (|lat| or |ky| out of
    bounds).
    """
    dy, err, _, _ = _rhs(bg, y, t, False)
    return dy, err


def rhs_and_gv(bg: Background, y: torch.Tensor, t=0.0):
    """rhs plus the raw-ky (ug, vg) of the evaluated state from the same
    background sample. Returns (dy (5, R), ug (R,), vg (R,))."""
    dy, _, ug, vg = _rhs(bg, y, t, True)
    return dy, ug, vg


class RayRHS:
    """The ray RHS over one background as a ``(y, t) -> dy`` callable, the
    form the integrators take; the single-group dense kernel reads ``bg``
    from it."""

    def __init__(self, bg: Background):
        self.bg = bg

    def __call__(self, y, t=0.0):
        return rhs(self.bg, y, t)[0]


def _rhs(bg, y, t, with_raw_gv: bool):
    if y.is_cuda:
        return _rhs_cuda(bg, y, with_raw_gv, t)
    return _rhs_core(bg, y, t, with_raw_gv)


def rhs_instance(r: int, dtype, variant: str = "") -> str:
    """The RHS kernel's instance for a launch of ``r`` lanes on the card
    (``variant`` "" or "_time", ``kernel_background``'s): the team in
    ``kernels.RHS_TEAM_LANES``' window where it fits the card's resident
    count, else one thread per lane."""
    return kernels.choose_instance(
        r, kernels.resident("rhs", kernels.TEAM, dtype, variant=variant),
        kernels.RHS_TEAM_LANES[variant])


def _rhs_cuda(bg: Background, y: torch.Tensor, with_raw_gv: bool, t=0.0,
              instance=None):
    """Launch the RHS kernel, in ``rhs_instance``'s instance unless
    ``instance`` (a key of ``kernels.INSTANCES``) is given. A state wider
    than the background (mixed precision) is cast to the background's dtype
    first, and so is the time, as ``_rhs_core`` casts them at entry. A
    static background takes the static instance, which reads no time; any
    other takes the time instance with the lanes' times (t a scalar or
    (R,))."""
    global LAUNCHES
    y = y.to(bg.fields.dtype)
    kernels.check_tensor(y, "y", device=y.device, dtype=y.dtype)
    if y.ndim != 2 or y.shape[0] != 5:
        raise ValueError(f"y must be (5, R); got {tuple(y.shape)}")
    r = y.shape[1]
    variant, bg_args = kernel_background(bg, y.device, y.dtype, r)
    dy = torch.empty_like(y)
    err = torch.empty(r, dtype=torch.bool, device=y.device)
    ug = torch.empty(r, dtype=y.dtype, device=y.device) if with_raw_gv else None
    vg = torch.empty(r, dtype=y.dtype, device=y.device) if with_raw_gv else None
    extra = ()
    if variant:
        if torch.is_tensor(t):
            t = t.to(device=y.device, dtype=y.dtype).expand(r).contiguous()
        else:
            t = torch.full((r,), float(t), dtype=y.dtype, device=y.device)
        extra = (t,)
    inst = instance or rhs_instance(r, y.dtype, variant)
    kernels.launch(f"rwrt_rhs{variant}", y.dtype, *bg_args, y, *extra, r,
                   dy, err, ug, vg, kernels.instance_id(inst),
                   kernels.stream(y.device))
    LAUNCHES += 1
    return dy, err, ug, vg


def _rhs_core(bg: Background, y: torch.Tensor, t, with_raw_gv: bool):
    """The plain PyTorch RHS (any device).

    Every NaN the semantics call for is applied as a FINAL where over values
    computed from NaN-free substitutes: dead lanes sample cell (0, 0), bad
    lanes compute with kx = 1, ky = 0, and the per-row NaN sets r0n..r4n are
    applied last. A NaN amp poisons row 4 only. A lane with kx == 0 is bad
    too (its IEEE rows are all NaN: kap = ky / 0), and a lane outside the
    latitude band samples at a finite position (``_sample_sanitized``): so
    in reverse mode a zero cotangent never meets a NaN or an inf.

    Mixed precision (a float64 state over a float32 background): the state
    and a tensor time are rounded to the background's dtype at entry, so
    the sample (its time lerp too) and all the algebra run there and dy
    comes out in it, as in the JAX package.
    """
    cdtype = bg.fields.dtype
    if y.dtype != cdtype:
        y = y.to(cdtype)
        if torch.is_tensor(t):
            t = t.to(cdtype)
    lon, lat, kx, ky, amp = y[S_LON], y[S_LAT], y[S_KX], y[S_KY], y[S_AMP]

    err = fail_mask(y)

    dead = (torch.isnan(lon) | torch.isnan(lat) | torch.isnan(kx)
            | torch.isnan(ky))
    ampn = torch.isnan(amp)
    bad = err | dead | (kx == 0.0)
    zero = torch.zeros_like(lon)
    one = torch.ones_like(lon)
    lat_q = torch.where(dead, zero, lat)
    kx_q = torch.where(bad, one, kx)
    ky_q = torch.where(bad, zero, ky)
    amp_q = torch.where(ampn, zero, amp)

    f = _sample_sanitized(bg, lon, lat, t, dead)
    fn = torch.isnan(f)
    f_q = torch.where(fn, torch.zeros_like(f), f)
    fmu, fmv = f_q[interp.M_U], f_q[interp.M_V]
    fmux, fmuy = f_q[interp.M_UX], f_q[interp.M_UY]
    fmvx, fmvy = f_q[interp.M_VX], f_q[interp.M_VY]
    fmqx, fmqy = f_q[interp.M_QX], f_q[interp.M_QY]
    fmqxx, fmqxy = f_q[interp.M_QXX], f_q[interp.M_QXY]
    fmqyx, fmqyy = f_q[interp.M_QYX], f_q[interp.M_QYY]
    n_u, n_v = fn[interp.M_U], fn[interp.M_V]
    n_qx, n_qy = fn[interp.M_QX], fn[interp.M_QY]

    ug, vg, _, _ = groupvel_mod.group_velocity_core(
        fmu, fmv, fmqx, fmqy, kx_q, ky_q)

    kap = ky_q / kx_q
    kap2 = kap * kap
    kap1 = 1.0 + kap2
    kk = kx_q * kx_q * kap1  # K^2 = k^2 + m^2

    dzwn = -kx_q * ((fmux + kap * fmvx) + (kap * fmqxx - fmqyx) / kk)
    dmwn = -kx_q * ((fmuy + kap * fmvy) + (kap * fmqxy - fmqyy) / kk)

    damp1 = 2.0 * (fmux + fmvy + kap * (fmvx + fmuy)) / kap1
    damp2 = 2.0 * (kap * (fmqxx - fmqyy) + (kap2 - 1.0) * fmqxy) / (kk * kap1)
    damp3 = -2.0 * torch.sin(lat_q) * fmv
    damp = damp1 + damp2 + damp3

    r0n = bad | n_u | n_qx | n_qy
    r1n = bad | n_v | n_qx | n_qy
    r2n = (bad | fn[interp.M_UX] | fn[interp.M_VX] | fn[interp.M_QXX]
           | fn[interp.M_QYX])
    r3n = (bad | fn[interp.M_UY] | fn[interp.M_VY] | fn[interp.M_QXY]
           | fn[interp.M_QYY])
    r4n = (bad | ampn | fn[interp.M_UX] | fn[interp.M_UY] | fn[interp.M_VX]
           | fn[interp.M_VY] | fn[interp.M_QXX] | fn[interp.M_QXY]
           | fn[interp.M_QYY] | n_v)

    inv_r = 1.0 / rearth
    nan = torch.full_like(lon, float("nan"))
    dy = torch.stack(
        [
            torch.where(r0n, nan, ug * inv_r),
            torch.where(r1n, nan, vg * torch.cos(lat_q) * inv_r),
            torch.where(r2n, nan, dzwn * inv_r),
            torch.where(r3n, nan, dmwn * inv_r),
            torch.where(r4n, nan, damp * amp_q * inv_r),
        ]
    )
    if with_raw_gv:
        # Raw semantics: err-by-|ky| lanes keep their real ky; dead lanes
        # and NaN-field samples are NaN.
        ug_r, vg_r = group_velocity(
            f[interp.M_U], f[interp.M_V], f[interp.M_QX], f[interp.M_QY],
            kx, ky)
        return dy, err, torch.where(dead, nan, ug_r), torch.where(
            dead, nan, vg_r)
    return dy, err, None, None


def group_velocity_at(bg: Background, lon, lat, kx, ky, t=0.0, *,
                      zero_invalid=False):
    """Diagnostic (ug, vg) at given positions/wavenumbers; NaN positions
    sample a sanitized cell and get their NaN back as a final where.

    Positions wider than the background (a float64 state over float32
    fields) are not rounded: the cell, the lerp over the background's
    corners, the time lerp, the Mercator transform and group velocity run
    in the positions' dtype, as the JAX package's promotion has them."""
    posn = torch.isnan(lon) | torch.isnan(lat)
    f = _sample_sanitized(bg, lon, lat, t, posn)
    ug, vg = group_velocity(
        f[interp.M_U], f[interp.M_V], f[interp.M_QX], f[interp.M_QY],
        kx, ky, zero_invalid=zero_invalid,
    )
    nan = torch.full_like(ug, float("nan"))
    mask = posn if not zero_invalid else (posn & (kx != 0.0))
    return torch.where(mask, nan, ug), torch.where(mask, nan, vg)


def haversine(lon_a, lat_a, lon_b, lat_b) -> torch.Tensor:
    """Angular distance between two points."""
    dlon = lon_a - lon_b
    dlat = lat_a - lat_b
    a = (
        torch.sin(dlat / 2.0) ** 2
        + torch.cos(lat_b) * torch.cos(lat_a) * torch.sin(dlon / 2.0) ** 2
    )
    return torch.abs(2.0 * interp.lane_op(torch.atan2, torch.sqrt(a),
                                          torch.sqrt(1.0 - a)))


def kill_mask(y_new: torch.Tensor, lon_prev, lat_prev,
              cut_off) -> torch.Tensor:
    """Post-step termination: True where |lat| >= pi/2 or the step jumped
    more than ``cut_off`` radians (haversine displacement)."""
    lat_kill = torch.abs(y_new[S_LAT]) >= 0.5 * pi
    ddis = haversine(y_new[S_LON], y_new[S_LAT], lon_prev, lat_prev)
    return lat_kill | (ddis >= cut_off)
