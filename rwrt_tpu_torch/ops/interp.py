"""Bilinear sampling of the background-field stack at ray positions.

Port of ``rwrt_tpu/ops/interp.py``: the 4-gather sampler
(``bilinear_gather``, ``sample_raw``, ``sample_mercator``), the
corner-packed single-gather sampler the RHS uses (``pack_corners``,
``_packed_cell``, ``_packed_corner_lerp``, ``sample_raw_packed``,
``sample_mercator_packed``) and the Mercator transform with its polar-cap
guard; the time-varying and ensemble variants (``sample_raw_time``,
``sample_mercator_time``, ``sample_raw_packed_time``,
``sample_raw_packed_member``, ``sample_raw_packed_member_time``), which
blend two frames linearly in time and fold a per-lane member offset into
the row index; and the samplers for gappy fields on any monotonic grid,
off the hot path (``bilinear_gather_masked``, ``linint2_point``).

Index conversion: the JAX package converts floor(index) to int32 and then
clips. Here the clip happens in floating point first (NaN goes to cell 0),
which is the same cell for every finite index and avoids torch's undefined
float-to-int conversion of NaN and out-of-range values.
"""

from __future__ import annotations

import torch

from rwrt_tpu_torch.constants import pi, polar_cos_cap

# Indices into the raw 18-field stack (models/basic_state.py FIELD_NAMES).
(F_U, F_V, F_UX, F_UY, F_VX, F_VY, F_QX, F_QY, F_QXX, F_QXY, F_QYX, F_QYY,
 F_QXXX, F_QXXY, F_QXYY, F_QYYY, F_QYXX, F_QYYX) = range(18)

# Indices into the Mercator-transformed sample.
(M_U, M_V, M_UX, M_UY, M_VX, M_VY, M_QX, M_QY, M_QXX, M_QXY, M_QYX, M_QYY,
 M_QXXX, M_QXXY, M_QXYY, M_QYYY, M_QYXX, M_QYYX) = range(18)

#: The ray RHS consumes only the first 12 fields; the third derivatives are
#: diagnostic-only.
NUM_HOT = 12


def true_div(x: torch.Tensor, s) -> torch.Tensor:
    """x / s with IEEE division on every device. PyTorch's CUDA division by
    a CPU scalar multiplies by its reciprocal instead, which rounds
    differently from the kernels and from the JAX package. The divisor is
    filled on the device, not copied from the host, so nothing waits."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


#: Elements the CPU's elementwise kernels take per trip of their vector
#: loop, at most (two vectors of an AVX-512 float32 register are 32), and
#: the most elements an op may hold and still run on one thread (PyTorch
#: splits an elementwise op over threads from 32,768 elements).
CPU_TRIP = 64
CPU_SERIAL = 16384


def lane_op(fn, *xs) -> torch.Tensor:
    """``fn(*xs)`` (pow or atan2: tensors of one shape, and Python scalars)
    so that no element's bits depend on where it lies in the batch.

    On the CPU, PyTorch's elementwise kernels run a vector loop (SLEEF)
    over whole trips and scalar libm over the tail, and the two round pow
    and atan2 differently, so a lane's bits would depend on the batch's
    width modulo the trip (and past 32,768 elements on the thread split).
    Here the operands run in slices of at most CPU_SERIAL elements, each
    padded with ones to whole trips. On CUDA each element is one thread's
    and ``fn(*xs)`` runs as it is. So a lane's rows do not depend on the
    lanes beside it: a lane subset, a mesh's shard or a compacted batch
    gives the bits the whole batch gives."""
    x0 = next(x for x in xs if torch.is_tensor(x))
    if x0.device.type != "cpu":
        return fn(*xs)
    flat = [x.reshape(-1) if torch.is_tensor(x) else x for x in xs]
    n = x0.numel()
    parts = []
    for s in range(0, max(n, 1), CPU_SERIAL):
        m = min(CPU_SERIAL, n - s)
        pad = (-m) % CPU_TRIP
        args = [torch.cat([x[s:s + m], x.new_ones(pad)])
                if torch.is_tensor(x) else x for x in flat]
        parts.append(fn(*args)[:m])
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out.reshape(x0.shape)


def _cell_index(x: torch.Tensor, n: int) -> torch.Tensor:
    """floor(x) clipped to [0, n-1] as int64; NaN maps to 0."""
    xf = torch.floor(x).clamp(0, n - 1)
    return torch.where(torch.isnan(xf), torch.zeros_like(xf), xf).long()


def bilinear_gather(fields: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """4-corner bilinear gather at fractional grid indices.

    fields: (W, H, C); x, y: (R,). Returns (R, C). Weights are computed
    against the CLIPPED corner indices, so out-of-range points extrapolate.
    """
    w, h, _ = fields.shape
    return _bilinear(fields.reshape(w * h, -1), w, h, x, y)


def _bilinear(flat, w, h, x, y, base=0):
    """``bilinear_gather`` over the (W, H) grid whose rows start at row
    ``base`` (an int, or per lane) of the (rows, C) table ``flat``."""
    x0 = _cell_index(x, w)
    x1 = (x0 + 1).clamp(0, w - 1)
    y0 = _cell_index(y, h)
    y1 = (y0 + 1).clamp(0, h - 1)

    sx = x - x0.to(x.dtype)
    sy = y - y0.to(y.dtype)

    fa = flat.index_select(0, base + x0 * h + y1)
    fb = flat.index_select(0, base + x1 * h + y1)
    fc = flat.index_select(0, base + x0 * h + y0)
    fd = flat.index_select(0, base + x1 * h + y0)

    wa = ((1.0 - sx) * sy)[:, None]
    wb = (sx * sy)[:, None]
    wc = ((1.0 - sx) * (1.0 - sy))[:, None]
    wd = (sx * (1.0 - sy))[:, None]
    return fa * wa + fb * wb + fc * wc + fd * wd


def bilinear_gather_masked(fields: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor, *,
                           fallback_mean: bool = False) -> torch.Tensor:
    """Bilinear gather with missing-value (NaN) corners: a result with any
    missing corner is missing, unless ``fallback_mean`` (the reference's
    nopt=-1), which takes the plain mean of the valid corners (NaN when
    none is). fields: (W, H, C); x, y: (R,) fractional indices. Returns
    (R, C)."""
    w, h, _ = fields.shape
    x0 = _cell_index(x, w)
    x1 = (x0 + 1).clamp(0, w - 1)
    y0 = _cell_index(y, h)
    y1 = (y0 + 1).clamp(0, h - 1)
    sx = (x - x0.to(x.dtype))[:, None]
    sy = (y - y0.to(y.dtype))[:, None]

    flat = fields.reshape(w * h, -1)
    corners = [flat.index_select(0, x0 * h + y1),
               flat.index_select(0, x1 * h + y1),
               flat.index_select(0, x0 * h + y0),
               flat.index_select(0, x1 * h + y0)]
    weights = [(1.0 - sx) * sy, sx * sy, (1.0 - sx) * (1.0 - sy),
               sx * (1.0 - sy)]
    interp_val = sum(c * wgt for c, wgt in zip(corners, weights))
    any_missing = sum(torch.isnan(c).int() for c in corners) > 0
    nan = torch.full_like(interp_val, float("nan"))
    if not fallback_mean:
        return torch.where(any_missing, nan, interp_val)
    valid = [~torch.isnan(c) for c in corners]
    n_valid = sum(v.to(interp_val.dtype) for v in valid)
    zero = torch.zeros_like(interp_val)
    mean_val = sum(torch.where(v, c, zero) for c, v in zip(corners, valid)) / (
        torch.clamp(n_valid, min=1.0))
    mean_val = torch.where(n_valid == 0, nan, mean_val)
    return torch.where(any_missing, mean_val, interp_val)


def linint2_point(xi, yi, fi, xo, yo, *, xcyclic: bool = True,
                  fo_missing: float = float("nan"),
                  nopt: int = 1) -> torch.Tensor:
    """Bilinear point interpolation on monotonic (possibly non-uniform)
    axes, the reference's scalar linint2_point vectorized:

    - x-cyclic: the period (xi[-1] - xi[0]) + (xi[1] - xi[0]) and one
      extension column on each side;
    - the interval by searchsorted - 1 (left side, as ``jnp.searchsorted``),
      clamped;
    - points out of range (y always; x when not cyclic) give fo_missing;
    - missing corners are found by EQUALITY with fo_missing, so a NaN
      sentinel never marks one and propagates through the arithmetic;
      nopt == -1 takes the plain mean of the corners that are not missing;
    - the two-step lerp (f11 + t (f21 - f11), then in y) keeps the
      reference's rounding.

    xi: (nx,), yi: (ny,) ascending; fi: (nx, ny); xo, yo: (R,) query
    points (tensors, or anything ``torch.as_tensor`` takes). Returns (R,).
    """
    xi, yi, fi, xo, yo = (torch.as_tensor(a) for a in (xi, yi, fi, xo, yo))
    if xcyclic:
        dx0 = xi[1] - xi[0]
        period = (xi[-1] - xi[0]) + dx0
        xo = torch.remainder(xo - xi[0], period) + xi[0]
        xi_use = torch.cat([xi[:1] - dx0, xi, xi[-1:] + dx0])
        fi_use = torch.cat([fi[-1:], fi, fi[:1]], dim=0)
    else:
        xi_use = xi
        fi_use = fi

    x_oob = (xo < xi_use[0]) | (xo > xi_use[-1])
    y_oob = (yo < yi[0]) | (yo > yi[-1])

    nx = torch.clamp(torch.searchsorted(xi_use, xo) - 1, 0,
                     xi_use.shape[0] - 2)
    ny = torch.clamp(torch.searchsorted(yi, yo) - 1, 0, yi.shape[0] - 2)

    f11 = fi_use[nx, ny]
    f21 = fi_use[nx + 1, ny]
    f12 = fi_use[nx, ny + 1]
    f22 = fi_use[nx + 1, ny + 1]

    t = (xo - xi_use[nx]) / (xi_use[nx + 1] - xi_use[nx])
    u = (yo - yi[ny]) / (yi[ny + 1] - yi[ny])
    f_low = f11 + t * (f21 - f11)
    f_high = f12 + t * (f22 - f12)
    fo = f_low + u * (f_high - f_low)

    corners = (f11, f21, f12, f22)
    any_missing = (corners[0] == fo_missing)
    for c in corners[1:]:
        any_missing = any_missing | (c == fo_missing)
    missing = torch.full_like(fo, fo_missing)
    if nopt == -1:
        valid = [c != fo_missing for c in corners]
        n_valid = sum(v.to(fo.dtype) for v in valid)
        zero = torch.zeros_like(fo)
        mean_val = sum(torch.where(v, c, zero) for c, v in zip(corners,
                                                                valid))
        mean_val = torch.where(
            n_valid > 0, mean_val / torch.clamp(n_valid, min=1.0), missing)
        fo = torch.where(any_missing, mean_val, fo)
    else:
        fo = torch.where(any_missing, missing, fo)
    return torch.where(x_oob | y_oob, missing, fo)


def _nan_outside_band(vals: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    in_range = torch.abs(lat) <= 0.5 * pi
    return torch.where(in_range[:, None], vals,
                       torch.full_like(vals, float("nan")))


def sample_raw(bs_fields, lon0, lat0, dx, dy, lon, lat) -> torch.Tensor:
    """Interpolate the raw field stack at (lon, lat); rows with
    |lat| > pi/2 are NaN. Returns (R, C)."""
    ix = true_div(torch.remainder(lon - lon0, 2.0 * pi), dx)
    iy = true_div(lat - lat0, dy)
    return _nan_outside_band(bilinear_gather(bs_fields, ix, iy), lat)


def mercator_transform(raw: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """Convert raw interpolated fields to Mercator coordinates.

    - everything is zeroed where |cos(lat)| <= polar_cos_cap; the mask is
      NOT(|cos| <= cap), so NaN latitudes stay live and propagate NaN;
    - fmuy = fuy + tan(lat) fu, with no division by cos (the convention the
      Fortran code kept);
    - both fmqxy and fmqyx come from the SMOOTHED qxy sample (index 9).

    raw: (R, 12) or (R, 18). Returns (C, R) in M_* order.
    """
    cos_phi = torch.cos(lat)
    sin_phi = torch.sin(lat)
    live = torch.logical_not(torch.abs(cos_phi) <= polar_cos_cap)
    cosm = torch.where(live, cos_phi, torch.full_like(cos_phi, 1e-6))
    tan_phi = sin_phi / cosm

    f = raw.T
    full = raw.shape[-1] > NUM_HOT
    zero = torch.zeros_like(cos_phi)

    def m(expr):
        return torch.where(live, expr, zero)

    fmqyx = m(f[F_QXY] * cosm)
    out = [None] * (18 if full else NUM_HOT)
    out[M_U] = m(f[F_U] / cosm)
    out[M_V] = m(f[F_V] / cosm)
    out[M_UX] = m(f[F_UX] / cosm)
    out[M_UY] = m(f[F_UY] + tan_phi * f[F_U])
    out[M_VX] = m(f[F_VX] / cosm)
    out[M_VY] = m(f[F_VY] + tan_phi * f[F_V])
    out[M_QX] = m(f[F_QX])
    out[M_QY] = m(f[F_QY] * cosm)
    out[M_QXX] = m(f[F_QXX])
    out[M_QXY] = fmqyx
    out[M_QYX] = fmqyx
    out[M_QYY] = m((f[F_QYY] * cosm - f[F_QY] * sin_phi) * cosm)
    if full:
        out[M_QXXX] = m(f[F_QXXX])
        out[M_QXXY] = m(f[F_QXXY] * cosm)
        out[M_QXYY] = m((f[F_QXYY] * cosm - f[F_QXY] * sin_phi) * cosm)
        out[M_QYYY] = m(f[F_QYYY])
        out[M_QYXX] = m(f[F_QYXX] * cosm)
        out[M_QYYX] = m((f[F_QYYX] * cosm - f[F_QXY] * sin_phi) * cosm)
    return torch.stack(out, dim=0)


def sample_mercator(bs_fields, lon0, lat0, dx, dy, lon, lat) -> torch.Tensor:
    """Interpolate + Mercator-transform; returns (C, R)."""
    raw = sample_raw(bs_fields, lon0, lat0, dx, dy, lon, lat)
    return mercator_transform(raw, lat)


def pack_corners(fields: torch.Tensor) -> torch.Tensor:
    """Pack each cell's 2x2 corner neighbourhood into one (W, H, 4C) row:
    [F(w,h), F(w+1,h), F(w,h+1), F(w+1,h+1)], the +1 neighbours clamped at
    the array edges exactly as the 4-gather path clamps its indices."""

    def shift(f, dim):
        return torch.cat([f.narrow(dim, 1, f.shape[dim] - 1),
                          f.narrow(dim, f.shape[dim] - 1, 1)], dim=dim)

    right = shift(fields, fields.ndim - 3)
    up = shift(fields, fields.ndim - 2)
    right_up = shift(right, fields.ndim - 2)
    return torch.cat([fields, right, up, right_up], dim=-1)


def _packed_cell(w, h, lon0, lat0, dx, dy, lon, lat):
    """Clamped (x0, y0) cell plus the bilinear offsets (sx, sy)."""
    ix = true_div(torch.remainder(lon - lon0, 2.0 * pi), dx)
    iy = true_div(lat - lat0, dy)
    x0 = _cell_index(ix, w)
    y0 = _cell_index(iy, h)
    sx = ix - x0.to(ix.dtype)
    sy = iy - y0.to(iy.dtype)
    return x0, y0, sx, sy


def _packed_corner_lerp(flat, row_idx, sx, sy, c):
    """ONE row gather + the bilinear corner combination, with the weight
    expression and summation order of the 4-gather path."""
    rows = flat.index_select(0, row_idx)
    fc = rows[:, 0:c]            # (x0, y0)
    fd = rows[:, c: 2 * c]       # (x1, y0)
    fa = rows[:, 2 * c: 3 * c]   # (x0, y1)
    fb = rows[:, 3 * c: 4 * c]   # (x1, y1)
    wa = ((1.0 - sx) * sy)[:, None]
    wb = (sx * sy)[:, None]
    wc = ((1.0 - sx) * (1.0 - sy))[:, None]
    wd = (sx * (1.0 - sy))[:, None]
    return fa * wa + fb * wb + fc * wc + fd * wd


def sample_raw_packed(packed, lon0, lat0, dx, dy, lon, lat) -> torch.Tensor:
    """Bilinear sample from a corner-packed stack: ONE row gather per point.
    Equal to sample_raw on the unpacked stack."""
    w, h, c4 = packed.shape
    c = c4 // 4
    x0, y0, sx, sy = _packed_cell(w, h, lon0, lat0, dx, dy, lon, lat)
    vals = _packed_corner_lerp(packed.reshape(w * h, c4), x0 * h + y0,
                               sx, sy, c)
    return _nan_outside_band(vals, lat)


def sample_mercator_packed(packed, lon0, lat0, dx, dy, lon, lat):
    """Corner-packed sample + Mercator transform; returns (C, R)."""
    raw = sample_raw_packed(packed, lon0, lat0, dx, dy, lon, lat)
    return mercator_transform(raw, lat)


def _frame_weights(tfrac: torch.Tensor, nt: int):
    """The bracketing frames (i0, i1) and the weight w1 of i1 at the
    fractional frame index ``tfrac``: tfrac clipped to [0, nt - 1] (NaN
    stays NaN), i0 its floor clipped the same way (NaN goes to frame 0),
    i1 = min(i0 + 1, nt - 1), w1 = tfrac - i0."""
    tf = torch.clamp(tfrac, 0.0, nt - 1.0)
    i0 = _cell_index(tf, nt)
    i1 = (i0 + 1).clamp(max=nt - 1)
    return i0, i1, tf - i0.to(tf.dtype)


def _time_blend(frame, i0, i1, w1):
    """frame(i0) * (1 - w1) + frame(i1) * w1, taken before the Mercator
    transform."""
    return frame(i0) * (1.0 - w1)[:, None] + frame(i1) * w1[:, None]


def sample_raw_time(bs_fields, lon0, lat0, dx, dy, lon, lat,
                    tfrac) -> torch.Tensor:
    """Time-varying variant of ``sample_raw``: bs_fields (T, W, H, C), tfrac
    (R,) the fractional frame index (held at the ends). Linear in time, as
    every precomputed field is linear in (u, v). Returns (R, C)."""
    nt, w, h, _ = bs_fields.shape
    i0, i1, w1 = _frame_weights(tfrac, nt)
    ix = true_div(torch.remainder(lon - lon0, 2.0 * pi), dx)
    iy = true_div(lat - lat0, dy)
    flat = bs_fields.reshape(nt * w * h, -1)

    def frame(ti):
        return _bilinear(flat, w, h, ix, iy, ti * (w * h))

    return _nan_outside_band(_time_blend(frame, i0, i1, w1), lat)


def sample_mercator_time(bs_fields, lon0, lat0, dx, dy, lon, lat, tfrac):
    """Time-varying sample + Mercator transform; returns (C, R)."""
    raw = sample_raw_time(bs_fields, lon0, lat0, dx, dy, lon, lat, tfrac)
    return mercator_transform(raw, lat)


def _packed_frames(flat, cell, frame_rows, i0, i1, w1, sx, sy, c):
    """Two row gathers, at frames i0 and i1 of the lanes' cells ``cell``
    (frame_rows rows a frame), blended in time."""

    def frame(ti):
        return _packed_corner_lerp(flat, ti * frame_rows + cell, sx, sy, c)

    return _time_blend(frame, i0, i1, w1)


def sample_raw_packed_time(packed, lon0, lat0, dx, dy, lon, lat, tfrac):
    """Time-varying corner-packed sample: packed (T, W, H, 4C), one row
    gather per bracketing frame, blended in time. Returns (R, C)."""
    nt, w, h, c4 = packed.shape
    i0, i1, w1 = _frame_weights(tfrac, nt)
    x0, y0, sx, sy = _packed_cell(w, h, lon0, lat0, dx, dy, lon, lat)
    vals = _packed_frames(packed.reshape(nt * w * h, c4), x0 * h + y0,
                          w * h, i0, i1, w1, sx, sy, c4 // 4)
    return _nan_outside_band(vals, lat)


def sample_raw_packed_member(packed, lon0, lat0, dx, dy, lon, lat, member):
    """Ensemble variant of ``sample_raw_packed``: packed (M, W, H, 4C), one
    stack per member, member (R,) each lane's member index. The member folds
    into the row index, so each lane's sample equals its member's own."""
    m, w, h, c4 = packed.shape
    x0, y0, sx, sy = _packed_cell(w, h, lon0, lat0, dx, dy, lon, lat)
    vals = _packed_corner_lerp(packed.reshape(m * w * h, c4),
                               member.long() * (w * h) + x0 * h + y0, sx, sy,
                               c4 // 4)
    return _nan_outside_band(vals, lat)


def sample_raw_packed_member_time(packed, lon0, lat0, dx, dy, lon, lat,
                                  member, tfrac):
    """Time-varying ensemble variant: packed (M, T, W, H, 4C), one frame
    sequence per member; member (R,) each lane's member, tfrac (R,) its
    fractional frame index. Equal per member to
    ``sample_raw_packed_time``."""
    m, nt, w, h, c4 = packed.shape
    i0, i1, w1 = _frame_weights(tfrac, nt)
    x0, y0, sx, sy = _packed_cell(w, h, lon0, lat0, dx, dy, lon, lat)
    vals = _packed_frames(packed.reshape(m * nt * w * h, c4),
                          member.long() * (nt * w * h) + x0 * h + y0, w * h,
                          i0, i1, w1, sx, sy, c4 // 4)
    return _nan_outside_band(vals, lat)
