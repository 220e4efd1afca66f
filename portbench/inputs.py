"""The inputs of a run, made from its seed: the background winds and the
ray sources.

The background is the repository's analytic 144 x 73 climatology (a jet of
25 cos^2(lat) + 30 exp(-((lat - 35) / 12)^2) m/s, u's stationary wave 3 of
6 cos^2(lat) and v's wave 2 of 4 cos(lat)), as ``climatology_frames``
makes it: daily frames whose jet amplitude varies by ``season`` over a
``period_days`` cycle and whose waves drift east ``drift_deg_per_day``, a
member's jet scaled and its waves shifted by a phase. Frame 0 at scale 1
and phase 0 is the static climatology bit for bit.

The sources are a configuration's own: its source matrix, or a fixed set
drawn at random (``numpy.random.default_rng(set_seed)``, uniform in
longitude and in latitude within the band). A run's seed changes their
order and nothing else, so every seed asks for the same work: seed 0 keeps
the order, and gives the inputs of the repository's earlier
measurements; any other seed permutes the sources (and so the rays' lanes
and the rays the check samples).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

DAY = 86400.0
DEG2RAD = 3.14159265358979323846264338327950288419716939937510 / 180.0


def climatology_frames(n_frames, scale=1.0, phase_deg=0.0, season=0.0,
                       period_days=1.0, drift_deg_per_day=0.0, nlon=144,
                       nlat=73):
    """``n_frames`` daily (u, v) frames of the climatology: (u (T, nlon,
    nlat), v, lat, lon), lat and lon in radians, ascending."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    jet = (25.0 * np.cos(lat)[None, :] ** 2
           + 30.0 * np.exp(-(((np.degrees(lat)[None, :] - 35.0) / 12.0) ** 2)))
    us, vs = [], []
    for day in range(n_frames):
        amp = scale * (1.0 + season * np.sin(2 * np.pi * day / period_days))
        x = lon - np.radians(drift_deg_per_day * day + phase_deg)
        us.append(amp * jet + 6.0 * np.cos(3 * x)[:, None]
                  * np.cos(lat)[None, :] ** 2)
        vs.append(4.0 * np.sin(2 * x)[:, None] * np.cos(lat)[None, :])
    return np.stack(us), np.stack(vs), lat, lon


def source_order(seed: int, count: int) -> np.ndarray:
    """The order a seed lays ``count`` sources out in: seed 0 keeps theirs,
    any other permutes them from a stream of its own."""
    if seed == 0:
        return np.arange(count)
    return np.random.default_rng([seed, 1]).permutation(count)


def source_matrix(sw_lon, sw_lat, dlon, dlat, nnx, nny):
    """A configuration's source matrix from its SW corner, in radians,
    x-fastest (``trace_rays``' default layout)."""
    ix = np.arange(nnx)
    iy = np.arange(nny)
    lon_deg = (sw_lon % 360.0 + ix[None, :] * dlon) % 360.0
    lat_deg = sw_lat + iy[:, None] * dlat
    lon = np.broadcast_to(lon_deg, (nny, nnx)).reshape(-1) * DEG2RAD
    lat = np.broadcast_to(lat_deg, (nny, nnx)).reshape(-1) * DEG2RAD
    return lon.astype(np.float64), lat.astype(np.float64)


def random_sources(set_seed: int, count: int, lat_max_deg: float):
    """``count`` sources uniform in longitude and in |lat| <= lat_max_deg,
    radians: (lon, lat)."""
    rng = np.random.default_rng(set_seed)
    lon = rng.uniform(0, 2 * np.pi, count)
    lat = rng.uniform(np.radians(-lat_max_deg), np.radians(lat_max_deg),
                      count)
    return lon, lat


class Wind(NamedTuple):
    """One member's winds: u, v (nlon, nlat), or (T, nlon, nlat) with the
    frames' spacing ``frame_dt`` (seconds; None for a static state)."""

    u: np.ndarray
    v: np.ndarray
    lat: np.ndarray
    lon: np.ndarray
    frame_dt: object


class Inputs(NamedTuple):
    """What the harness hands the program and the reference alike: the
    members' winds, and the sources in radians."""

    winds: List[Wind]
    source_lon: object
    source_lat: object


def make_inputs(config: dict, traffic: dict, seed: int) -> Inputs:
    """The inputs of one run of a cell: ``config`` and ``traffic`` are the
    cell's two files (``portbench/configs``, ``portbench/traffic``)."""
    grid = config["grid"]
    bgd = traffic["background"]
    frames = int(bgd.get("frames", 1))
    winds = []
    for member in bgd.get("members", [{}]):
        u, v, lat, lon = climatology_frames(
            frames, scale=float(member.get("scale", 1.0)),
            phase_deg=float(member.get("phase_deg", 0.0)),
            season=float(bgd.get("season", 0.0)),
            period_days=float(bgd.get("period_days", 1.0)),
            drift_deg_per_day=float(bgd.get("drift_deg_per_day", 0.0)),
            nlon=int(grid["nlon"]), nlat=int(grid["nlat"]))
        if frames == 1:
            winds.append(Wind(u[0], v[0], lat, lon, None))
        else:
            winds.append(Wind(u, v, lat, lon,
                              float(bgd.get("frame_dt_s", DAY))))
    src = config["sources"]
    if src["kind"] == "random":
        slon, slat = random_sources(int(src["set_seed"]), int(src["count"]),
                                    float(src["lat_max_deg"]))
    elif src["kind"] == "matrix":
        run = config["run"]
        slon, slat = source_matrix(run["sw_lon"], run["sw_lat"],
                                   run["dlon"], run["dlat"], int(run["nnx"]),
                                   int(run["nny"]))
    else:
        raise ValueError(f"unknown sources kind {src['kind']!r}")
    order = source_order(seed, len(slon))
    return Inputs(winds, slon[order], slat[order])


def ray_count(config: dict, inputs: Inputs) -> int:
    """The rays of one request: 3 roots x sources x zwn, each member's."""
    return (3 * len(inputs.source_lon) * len(config["run"]["zwn"])
            * len(inputs.winds))
