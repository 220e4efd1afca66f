"""Rossby-wave rays from the equations, over a basic state
(``reference.state``): the background sample, the dispersion roots, the
group velocity, the ray equations and the RK4 step.

Sample. Bilinear in the cell (floor of the fractional index, clamped to the
grid, the +1 corner clamped to the last row and column; the lon wrap column
closes the circle), NaN outside |lat| <= pi/2; time-varying winds lerped
linearly between the two frames about the time (clamped to the first and
last); then to Mercator form, zero where |cos lat| <= 0.0175:
u / c, v / c, u_x / c, u_y + t u, v_x / c, v_y + t v, q_x, q_y c, q_xx,
q_xy c, (q_yy c - q_y s) c, with c, s, t the cosine, sine and tangent.

Dispersion (stationary waves, k = zwn the zonal wavenumber times R):
    v m^3 + k (u - p) m^2 + (k^2 v + q_x) m + k^3 (u - p) - q_y k = 0,
p = freq R / k; a ray per root, the roots real (a pair whose imaginary part
is under 1e-8 counted real, as its real part), |m| < 100, ordered
non-negative first, each by |m|, then the missing ones (NaN).

Group velocity, with kap = m / k:
    ug = u + ((1 - kap^2) q_y - 2 kap q_x) / (k^2 (1 + kap^2)^2)
    vg = v + (2 kap q_y + (1 - kap^2) q_x) / (k^2 (1 + kap^2)^2)

Ray equations for the state (lon, lat, k, m, amp), with K^2 = k^2 (1 +
kap^2), over R: dlon = ug, dlat = vg cos lat,
    dk = -k ((u_x + kap v_x) + (kap q_xx - q_xy) / K^2)
    dm = -k ((u_y + kap v_y) + (kap q_xy - q_yy) / K^2)
    damp = amp (2 (u_x + v_y + kap (v_x + u_y)) / (1 + kap^2)
                + 2 (kap (q_xx - q_yy) + (kap^2 - 1) q_xy) / (K^2 (1 + kap^2))
                - 2 sin(lat) v),
all NaN where |lat| >= pi/2, |m| >= 100 (the ray fails there) or k = 0.

RK4: fixed steps; a step any of whose four stages fails leaves the ray
where it is; after the step the ray dies (NaN) where |lat| >= pi/2 or it
moved ``cut_off`` radians or more. A ray with no root is NaN from row 1.
(ug, vg) of a row are taken at its state and time.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from portbench.reference.state import REARTH

HALF_PI = math.pi / 2
MWN_CAP = 100.0
POLAR_COS = 0.0175
IM_REAL = 1e-8
#: The stacked fields a sample reads (``state.NAMES``): u, v, ux, uy, vx,
#: vy, qx, qy, qxx, qxy (smoothed), qyy.
SAMPLED = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11)


class Background:
    """The members' states stacked for sampling: one state a member, each
    static or a sequence of frames ``frame_dt`` seconds apart from t = 0."""

    def __init__(self, fields: List[torch.Tensor], frame_dt: Optional[float],
                 dtype):
        f = torch.stack([x if x.ndim == 4 else x[None] for x in fields])
        self.n_members, self.n_frames, self.w, self.h, _ = f.shape
        self.flat = f[..., list(SAMPLED)].to(dtype).reshape(
            -1, len(SAMPLED)).contiguous()
        self.frame_dt = frame_dt
        self.dx = 2 * math.pi / (self.w - 1)
        self.dy = math.pi / (self.h - 1)

    def _corners(self, base, lon, lat):
        ix = torch.remainder(lon, 2 * math.pi) / self.dx
        iy = (lat + HALF_PI) / self.dy

        def cell(i, n):
            c = torch.nan_to_num(torch.floor(i), nan=0.0).clamp(0, n - 1)
            return c.long(), i - c

        x0, sx = cell(ix, self.w)
        y0, sy = cell(iy, self.h)
        x1 = (x0 + 1).clamp(max=self.w - 1)
        y1 = (y0 + 1).clamp(max=self.h - 1)

        def at(x, y):
            return self.flat.index_select(0, base + x * self.h + y)

        sx, sy = sx[:, None], sy[:, None]
        return ((at(x0, y0) * (1 - sx) + at(x1, y0) * sx) * (1 - sy)
                + (at(x0, y1) * (1 - sx) + at(x1, y1) * sx) * sy)

    def sample(self, lon, lat, t, member):
        """The Mercator fields (11, N) at positions (N,), time t (a float or
        (N,)) and members (N,) int64."""
        frame = self.w * self.h
        base = member * (self.n_frames * frame)
        if self.n_frames == 1:
            raw = self._corners(base, lon, lat)
        else:
            tf = (torch.as_tensor(t, dtype=lon.dtype, device=lon.device)
                  / self.frame_dt).expand_as(lon).clamp(0, self.n_frames - 1)
            i0 = torch.floor(tf).long()
            i1 = (i0 + 1).clamp(max=self.n_frames - 1)
            w1 = (tf - i0)[:, None]
            raw = (self._corners(base + i0 * frame, lon, lat) * (1 - w1)
                   + self._corners(base + i1 * frame, lon, lat) * w1)
        raw = torch.where((lat.abs() <= HALF_PI)[:, None], raw,
                          torch.full_like(raw, math.nan))
        u, v, ux, uy, vx, vy, qx, qy, qxx, qxy, qyy = raw.T
        cos, sin = torch.cos(lat), torch.sin(lat)
        live = ~(cos.abs() <= POLAR_COS)
        c = torch.where(live, cos, torch.ones_like(cos))
        tan = sin / c
        out = torch.stack([u / c, v / c, ux / c, uy + tan * u, vx / c,
                           vy + tan * v, qx, qy * c, qxx, qxy * c,
                           (qyy * c - qy * sin) * c])
        return torch.where(live, out, torch.zeros_like(out))


def group_velocity(f, k, m):
    """(ug, vg) from the Mercator fields f (11, N) and wavenumbers k, m."""
    kap = m / k
    kap2 = kap * kap
    den = k * k * (1 + kap2) ** 2
    ug = f[0] + ((1 - kap2) * f[7] - 2 * kap * f[6]) / den
    vg = f[1] + (2 * kap * f[7] + (1 - kap2) * f[6]) / den
    return ug, vg


def rhs(bg: Background, y, t, member):
    """(dy (5, N), fail (N,)): the ray equations' right-hand side."""
    lon, lat, k, m, amp = y
    f = bg.sample(lon, lat, t, member)
    fu, fv, fux, fuy, fvx, fvy, fqx, fqy, fqxx, fqxy, fqyy = f
    kap = m / k
    kap2 = kap * kap
    kap1 = 1 + kap2
    kk = k * k * kap1
    ug, vg = group_velocity(f, k, m)
    dk = -k * ((fux + kap * fvx) + (kap * fqxx - fqxy) / kk)
    dm = -k * ((fuy + kap * fvy) + (kap * fqxy - fqyy) / kk)
    da = (2 * (fux + fvy + kap * (fvx + fuy)) / kap1
          + 2 * (kap * (fqxx - fqyy) + (kap2 - 1) * fqxy) / (kk * kap1)
          - 2 * torch.sin(lat) * fv)
    dy = torch.stack([ug, vg * torch.cos(lat), dk, dm, da * amp]) / REARTH
    fail = (lat.abs() >= HALF_PI) | (m.abs() >= MWN_CAP)
    return torch.where(fail | (k == 0), math.nan, dy), fail


def roots(fu, fv, fqx, fqy, k, freq: float, dtype) -> np.ndarray:
    """The meridional wavenumbers (N, 3) of points (N,) (numpy, computed in
    ``dtype``): the companion matrix's eigenvalues, each real one refined
    by two Newton steps; a quadratic or linear equation where the higher
    coefficients vanish against the others over |m| < 100."""
    fu, fv, fqx, fqy, k = (np.asarray(a, dtype) for a in
                           (fu, fv, fqx, fqy, k))
    kz = np.where(k == 0, 1, k).astype(dtype)
    a = fu - dtype(freq * REARTH) / kz
    c = np.stack([fv, kz * a, kz * kz * fv + fqx, kz ** 3 * a - fqy * kz], -1)
    size = np.abs(c) * np.array([MWN_CAP ** 3, MWN_CAP ** 2, MWN_CAP, 1],
                                dtype)
    small = size < 1e3 * np.finfo(dtype).eps * size.max(-1, keepdims=True)
    n = c.shape[0]
    out = np.full((n, 3), np.nan, dtype)
    cubic = ~small[:, 0]
    if cubic.any():
        cc = c[cubic]
        comp = np.zeros((cc.shape[0], 3, 3), dtype)
        comp[:, 0] = -cc[:, 1:] / cc[:, :1]
        comp[:, 1, 0] = comp[:, 2, 1] = 1
        ev = np.linalg.eigvals(comp)
        out[cubic] = np.where(np.abs(ev.imag) < IM_REAL, ev.real, np.nan)
    quad = small[:, 0] & ~small[:, 1]
    if quad.any():
        c2, c1, c0 = c[quad, 1], c[quad, 2], c[quad, 3]
        disc = c1 * c1 - 4 * c2 * c0
        sq = np.sqrt(np.abs(disc))
        real = (disc >= 0) | (sq / (2 * np.abs(c2)) < IM_REAL)
        sign = np.where(c1 >= 0, 1, -1)
        big = -0.5 * (c1 + sign * np.where(disc >= 0, sq, 0))
        r0 = np.where(disc >= 0, big / c2, -c1 / (2 * c2))
        r1 = np.where(disc >= 0, np.where(big != 0, c0 / np.where(
            big != 0, big, 1), 0), r0)
        out[quad, 0] = np.where(real, r0, np.nan)
        out[quad, 1] = np.where(real, r1, np.nan)
    lin = small[:, 0] & small[:, 1] & ~small[:, 2]
    out[lin, 0] = -c[lin, 3] / c[lin, 2]
    with np.errstate(all="ignore"):
        for _ in range(2):
            p = ((c[:, :1] * out + c[:, 1:2]) * out + c[:, 2:3]) * out \
                + c[:, 3:]
            dp = (3 * c[:, :1] * out + 2 * c[:, 1:2]) * out + c[:, 2:3]
            step = p / np.where(dp == 0, 1, dp)
            ok = np.isfinite(step) & (np.abs(step) < 1e-3 * (1 + np.abs(out)))
            out = np.where(ok, out - step, out)
    out = np.where(np.isfinite(out) & (np.abs(out) < MWN_CAP)
                   & (k != 0)[:, None], out, np.nan)
    key = np.where(np.isnan(out), np.inf, np.abs(out) + 200.0 * (out < 0))
    return np.take_along_axis(out, np.argsort(key, -1, kind="stable"), -1)


class Seeds(NamedTuple):
    """Row 0 of every ray: y0 (5, R), ug0, vg0 (R,), each ray's member (R,),
    C order of (member, root, source, zwn)."""

    y0: torch.Tensor
    ug0: torch.Tensor
    vg0: torch.Tensor
    member: torch.Tensor


def seed(bg: Background, source_lon, source_lat, zwn, freq: float,
         dtype) -> Seeds:
    """Every ray's start: each member's sources x zwn x roots."""
    dev = bg.flat.device
    npd = np.dtype(str(dtype).removeprefix("torch."))
    slon = torch.as_tensor(np.asarray(source_lon), device=dev).to(dtype)
    slat = torch.as_tensor(np.asarray(source_lat), device=dev).to(dtype)
    kz = np.asarray(zwn, dtype=np.float64)
    ns, nz = slon.shape[0], kz.size
    parts = []
    for mem in range(bg.n_members):
        member = torch.full((ns,), mem, dtype=torch.long, device=dev)
        f = bg.sample(slon, slat, 0.0, member)
        fu, fv, fqx, fqy = (f[i].cpu().numpy().astype(np.float64).repeat(nz)
                            for i in (0, 1, 6, 7))
        kk = np.tile(kz, ns)
        m = roots(fu, fv, fqx, fqy, kk, freq, npd.type).reshape(ns, nz, 3)
        m = torch.as_tensor(m.transpose(2, 0, 1).copy(), device=dev).to(
            dtype)
        shape = (3, ns, nz)
        k = torch.as_tensor(kz, device=dev).to(dtype).expand(shape)
        fs = f[:, None, :, None].expand(f.shape[0], *shape)
        ug, vg = group_velocity(fs, k, m)
        y0 = torch.stack([slon[None, :, None].expand(shape),
                          slat[None, :, None].expand(shape), k, m,
                          torch.where(torch.isnan(m), math.nan,
                                      torch.ones_like(m))])
        parts.append((y0.reshape(5, -1), ug.reshape(-1), vg.reshape(-1),
                      torch.full((3 * ns * nz,), mem, dtype=torch.long,
                                 device=dev)))
    y0, ug0, vg0, member = (torch.cat(x, -1) for x in zip(*parts))
    return Seeds(y0, ug0, vg0, member)


def haversine(lon_a, lat_a, lon_b, lat_b):
    a = (torch.sin((lat_a - lat_b) / 2) ** 2 + torch.cos(lat_a)
         * torch.cos(lat_b) * torch.sin((lon_a - lon_b) / 2) ** 2)
    return (2 * torch.atan2(torch.sqrt(a), torch.sqrt(1 - a))).abs()


def killed(y, lon_prev, lat_prev, cut_off):
    return ((y[1].abs() >= HALF_PI)
            | (haversine(y[0], y[1], lon_prev, lat_prev) >= cut_off))


def rk4_step(bg: Background, y, t, dt: float, member, cut_off: float):
    """One RK4 step of rays y (5, N) from time t (a float or (N,)): the new
    row, NaN where the ray dies; a ray any of whose stages fails stays."""
    k1, e1 = rhs(bg, y, t, member)
    k2, e2 = rhs(bg, y + dt / 2 * k1, t + dt / 2, member)
    k3, e3 = rhs(bg, y + dt / 2 * k2, t + dt / 2, member)
    k4, e4 = rhs(bg, y + dt * k3, t + dt, member)
    ok = ~(e1 | e2 | e3 | e4)
    yn = torch.where(ok, y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4), y)
    return torch.where(killed(yn, y[0], y[1], cut_off), math.nan, yn)


def gv_at(bg: Background, y, t, member):
    """(ug, vg) of rays y (5, N) at time t."""
    return group_velocity(bg.sample(y[0], y[1], t, member), y[2], y[3])


def run_rk4(bg: Background, seeds: Seeds, dt: float, nt: int,
            cut_off: float):
    """Every ray's rows from its seed by fixed RK4 steps: ys (nt, 5, R),
    ugs, vgs (nt, R)."""
    r = seeds.y0.shape[1]
    ys = seeds.y0.new_full((nt, 5, r), math.nan)
    ugs = seeds.y0.new_full((nt, r), math.nan)
    vgs = seeds.y0.new_full((nt, r), math.nan)
    ys[0], ugs[0], vgs[0] = seeds.y0, seeds.ug0, seeds.vg0
    live = torch.nonzero(~torch.isnan(seeds.y0[3])).squeeze(1)
    y, mem = seeds.y0[:, live], seeds.member[live]
    for s in range(nt - 1):
        y = rk4_step(bg, y, s * dt, dt, mem, cut_off)
        ys[s + 1][:, live] = y
        ugs[s + 1][live], vgs[s + 1][live] = gv_at(bg, y, (s + 1) * dt, mem)
    return ys, ugs, vgs
