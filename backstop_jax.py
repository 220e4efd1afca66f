#!/usr/bin/env python3
"""Run the JAX package's exact mode on the lanes that ``exact_backstop.py``
found at the max_iters backstop.

    JAX_PLATFORMS=cpu python3 backstop_jax.py NPZ [--dtype float32|float64]

Reads the ``.npz`` that ``exact_backstop.py`` wrote (the background's winds,
the lanes' sources and their carry at the entry of the group where the
PyTorch port's run first spent the backstop) and runs ``rwrt_tpu`` on the
CPU in ``--dtype``:

  group   ``tracer._rk45_group_chunk`` (the JAX exact runner's unit) over
          that group's bounds from the port's entry carry (cast to
          ``--dtype``), one call per group: each lane's step attempts, and
          where it stands at the end (t, h, the spacing of numbers at t),
          beside the port's
  steps   each lane alone from the same carry, one trip per call, until
          its t has stood still for STILL trips: the trip at which t last
          moved, by how much its last moves took it, and the (h, rejected)
          states that the trips after it cycle through
  trace   the same rays from t = 0: ``initialize``, ``initial_step_sizes``
          and the rhs at t = 0, then group by group ``_rk45_group_chunk``
          and the truncation count of ``_run_rk45_grouped``'s exact branch
          (a lane short of its group's last bound while alive), up to the
          end of the latest of those groups; each lane's attempts per group,
          and how many of 2 * ULPS copies of each ray, their source
          longitude 1..ULPS ulps to either side, reach the backstop, die or
          live to the end

A lane "reaches the backstop" where its attempts in a group equal the
run's max_iters (from the ``.npz``). Imports nothing of the PyTorch port.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

#: Copies of each ray on either side, one more ulp of source longitude each.
ULPS = 16
#: Trips without a move of t after which ``steps`` calls a lane stalled,
#: and the most trips it walks.
STILL, MAX_STEPS = 200, 20_000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("npz")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import rwrt_tpu as rt
    from rwrt_tpu import tracer as jt
    from rwrt_tpu.models import ray as jray
    from rwrt_tpu.solvers import rk45

    d = np.load(args.npz)
    max_iters = int(d["max_iters"])
    dt = np.dtype(args.dtype)
    cast = lambda x: jnp.asarray(np.asarray(x, dt))  # noqa: E731
    bs = rt.prepare(d["u"], d["v"], d["lat"], d["lon"], cal_dtype=args.dtype)
    bg = jt.make_background(bs, 0.0)
    rtol = rk45.validate_tol(float(d["rtol"]), dt)
    atol, min_step, cut_off = (cast(d[k]) for k in ("atol", "min_step",
                                                    "cut_off"))
    n = d["lane"].size
    group = d["bounds"].shape[1]
    print(f"{args.dtype}: {n} lanes from {args.npz}; port's first backstop "
          f"groups {d['group'].tolist()}, max_iters {max_iters:,}")

    def chunk(carry, bounds):
        t0 = time.perf_counter()
        carry, out = jt._rk45_group_chunk(
            bg, *carry, bounds, cut_off, rtol, atol, min_step,
            max_iters=max_iters)
        lane_att = np.asarray(out[5])
        return carry, lane_att, time.perf_counter() - t0

    # group: from the port's entry carry, one call per group.
    for g in np.unique(d["group"]):
        sel = d["group"] == g
        carry = tuple(cast(d[k][..., sel]) for k in ("y", "t", "h", "f",
                                                     "prev_lon", "prev_lat"))
        bounds = cast(d["bounds"][sel][0])
        (y, t, h, *_), lane_att, s = chunk(carry, bounds)
        t, h = np.asarray(t), np.asarray(h)
        alive = ~np.isnan(np.asarray(y)[0])
        for j, lane in enumerate(d["lane"][sel]):
            stall = "yes" if lane_att[j] == max_iters else "no"
            print(f"group {g}, lane {lane}: JAX attempts {lane_att[j]} "
                  f"(port {d['lane_att'][g, np.nonzero(sel)[0][j]]}), "
                  f"backstop {stall}; entry t {float(carry[1][j])!r} s, end t "
                  f"{float(t[j])!r} s (port {float(d['t_exit'][sel][j])!r})"
                  f" of {float(bounds[-1])!r}, alive {bool(alive[j])}, h "
                  f"{float(h[j])!r} s (port {float(d['h_exit'][sel][j])!r}),"
                  f" spacing at t {float(np.spacing(t[j]))!r} s")
        print(f"group {g}: {s:.1f} s")

    # steps: integrate_group with max_iters 1, resumed through state0.
    def rhs_fn(yy, tt=0.0):
        return jray.rhs(bg, yy, tt)[0]

    def rhs_gv_fn(yy, tt=0.0):
        return jray.rhs_and_gv(bg, yy, tt)

    @jax.jit
    def trip(carry, state, bounds):
        y, t, h, f, prev_lon, prev_lat = carry
        out = rk45.integrate_group(
            rhs_fn, rhs_gv_fn, y, t, h, f, bounds, prev_lon, prev_lat,
            cut_off, rtol, atol, min_step, max_iters=1, state0=state)
        return out[1:7], (out[0], out[10], out[11], out[9], out[12])

    for j, lane in enumerate(d["lane"]):
        carry = tuple(cast(d[k][..., j:j + 1]) for k in (
            "y", "t", "h", "f", "prev_lon", "prev_lat"))
        bounds = cast(d["bounds"][j])
        state, log, moved, finished = None, [], 0, False
        while (not finished and len(log) < MAX_STEPS
               and len(log) - moved <= STILL):
            t_in = float(carry[1][0])
            carry, state = trip(carry, state, bounds)
            t, h = float(carry[1][0]), float(carry[2][0])
            log.append((t - t_in, h, bool(state[1][0])))
            moved = len(log) if t != t_in else moved
            finished = int(state[4][0]) >= bounds.shape[0]
        t = np.asarray(carry[1], dt)[0]
        moves = sorted({m for m, _, _ in log[max(moved - 30, 0):moved] if m})
        cycle = sorted({(h, r) for _, h, r in log[moved:]})
        print(f"steps lane {lane}: {len(log)} trips, t last moved at trip "
              f"{moved}, to {float(t)!r} s (spacing {float(np.spacing(t))!r}"
              f" s); its last 30 trips moved t by {moves} s; accepted trips "
              f"that left t where it was: "
              f"{sum(1 for m, _, r in log if not m and not r)}; after it "
              f"(h s, rejected) {cycle[:6]}"
              + ("; the group finished" if finished else ""))

    # trace: the same rays from t = 0, group by group, each beside copies
    # of it whose source longitude lies 1..ULPS ulps to either side.
    slon, slat, zwn = (np.asarray(d[k], dt) for k in ("source_lon",
                                                       "source_lat", "zwn"))
    shifts = np.arange(-ULPS, ULPS + 1)
    bits = np.int32 if dt == np.float32 else np.int64
    # (copies, n) sources; longitudes are positive, so their bit patterns
    # count ulps.
    elon = (slon.view(bits)[None, :] + shifts[:, None].astype(bits)).view(dt)
    elat = np.broadcast_to(slat, elon.shape)
    zs = np.unique(zwn)
    y0, _, _ = jt.initialize(bg, jnp.asarray(elon.ravel()),
                             jnp.asarray(elat.ravel()), jnp.asarray(zs))
    # Ray (root, source, zwn) of the (3, copies * n, nz) batch per member.
    src = np.arange(elon.size).reshape(elon.shape)
    pick = (d["root"] * elon.size * zs.size + src * zs.size
            + np.searchsorted(zs, zwn)).ravel()
    y0 = y0[:, pick]
    h0 = jt.initial_step_sizes(bg, y0, rtol, atol)
    f0 = jray.rhs(bg, y0, 0.0)[0]
    carry = (y0, jnp.zeros_like(y0[0]), h0, f0, y0[0], y0[1])
    step = cast(d["tstep"])
    n_groups = int(d["group"].max()) + 1
    att = np.zeros((n_groups, pick.size), np.int64)
    trunc = np.zeros((n_groups, pick.size), bool)
    t0 = time.perf_counter()
    for g in range(n_groups):
        bounds = jnp.arange(g * group + 1, (g + 1) * group + 1,
                            dtype=dt) * step
        carry, att[g], _ = chunk(carry, bounds)
        trunc[g] = ((np.asarray(carry[1]) < np.asarray(bounds)[-1])
                    & ~np.isnan(np.asarray(carry[0])[0]))
    dead = np.isnan(np.asarray(carry[0])[0]).reshape(elon.shape)
    capped = (att == max_iters).reshape(n_groups, *elon.shape)
    stalled = capped.any(axis=0)
    first = capped.argmax(axis=0)
    att = att.reshape(n_groups, *elon.shape)
    trunc = trunc.reshape(n_groups, *elon.shape)
    print(f"trace from t = 0 over {n_groups} groups of {group} bounds, "
          f"{shifts.size} copies of each ray: "
          f"{time.perf_counter() - t0:.1f} s")
    mid = ULPS
    for j, lane in enumerate(d["lane"]):
        hit = np.nonzero(att[:, mid, j] == max_iters)[0].tolist()
        where = dict(zip(shifts[stalled[:, j]].tolist(),
                         first[stalled[:, j], j].tolist()))
        print(f"trace lane {lane} (root {d['root'][j]}, source "
              f"({np.degrees(slon[j]):.4f}E, {np.degrees(slat[j]):.4f}N), "
              f"zwn {zwn[j]:g}): backstop groups {hit}, truncated groups "
              f"{np.nonzero(trunc[:, mid, j])[0].tolist()}; attempts per "
              f"group {att[:, mid, j].tolist()} (port "
              f"{d['lane_att'][:n_groups, j].tolist()}); of the "
              f"{shifts.size} copies {int(stalled[:, j].sum())} reach the "
              f"backstop (shift: first group {where}), "
              f"{int((dead[:, j] & ~stalled[:, j]).sum())} die, "
              f"{int((~dead[:, j] & ~stalled[:, j]).sum())} live to the end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
