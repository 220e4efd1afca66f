"""Host-side IO: background ingest and result output.

Port of ``rwrt_tpu/io/ncio.py``, with the same variable names, dimensions,
dtypes and files, so each package reads what the other writes:

- ``load_wind``: reads u, v, auto-detects lat/lon/time variable names from
  candidate lists, builds a regular grid with a warning if absent,
  transposes (lat, lon) -> (lon, lat), flips latitude to ascending order
  and rolls a -180..180 longitude axis to the 0-based convention.
- ``write_basic_state`` / ``load_basic_state``: the 23 diagnostic fields +
  coordinates, and the stage-level restart from them.
- ``write_trajectories`` / ``load_trajectories``: dims (time, root, source,
  zwn), lon/lat converted to degrees.
- ``write_wavenumber_maps``: the grid-wide wavenumber product.

netCDF4 is optional, so every function gates on it: a ``.npz`` path always
uses the npz container (same variable names), writing to another path
without netCDF4 falls back to ``<path>.npz``, and reading a NetCDF file
without netCDF4 raises RuntimeError. Tensors reach numpy through ``.cpu()``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rwrt_tpu_torch.constants import deg2rad, rad2deg
from rwrt_tpu_torch.convert import host
from rwrt_tpu_torch.models.basic_state import (FIELD_NAMES, BasicState,
                                               as_dtype)
from rwrt_tpu_torch.ops import grid as g

try:  # pragma: no cover - environment dependent
    import netCDF4 as _nc

    # A module without __file__ is an in-memory stand-in, not an
    # installation that can do file IO.
    HAVE_NETCDF = getattr(_nc, "__file__", None) is not None
    if not HAVE_NETCDF:
        _nc = None
except ImportError:  # pragma: no cover
    _nc = None
    HAVE_NETCDF = False

LAT_CANDIDATES = ("lat", "latitude", "Lat", "Latitude")
LON_CANDIDATES = ("lon", "longitude", "Lon", "Longitude")
TIME_CANDIDATES = ("time", "times", "Time", "t")


def _is_npz(path: str) -> bool:
    return str(path).endswith(".npz")


def load_wind(path: str, read_dtype="float32", *, with_time: bool = False):
    """Load (u, v, lat, lon) as numpy; u/v returned (nlon, nlat), lat
    ascending radians.

    Accepts NetCDF (requires netCDF4) or .npz with keys u, v [, lat, lon,
    time] where u/v are (lat, lon) like the NetCDF convention. A 3-D input
    (time, lat, lon) comes back as (T, nlon, nlat), the shape
    ``models.basic_state.prepare_time_varying`` takes. With
    ``with_time=True`` a fifth element is returned: the input's time
    coordinate (raw values, seconds by convention; None when absent).
    """
    times = None
    if _is_npz(path):
        with np.load(path) as ds:
            u = np.asarray(ds["u"], read_dtype)
            v = np.asarray(ds["v"], read_dtype)
            lat = np.asarray(ds["lat"], np.float64) if "lat" in ds else None
            lon = np.asarray(ds["lon"], np.float64) if "lon" in ds else None
            for name in TIME_CANDIDATES:
                if name in ds:
                    times = np.asarray(ds[name], np.float64)
                    break
    else:
        if not HAVE_NETCDF:
            raise RuntimeError(
                "netCDF4 is not installed; convert the input to .npz "
                "(keys u, v, lat, lon) or install netCDF4"
            )
        with _nc.Dataset(path) as ds:  # pragma: no cover
            # netCDF4 auto-masks _FillValue/missing_value cells; fill with
            # NaN (the pipeline's undef) rather than keeping the raw fill.
            u = np.asarray(np.ma.filled(ds.variables["u"][:], np.nan),
                           read_dtype)
            v = np.asarray(np.ma.filled(ds.variables["v"][:], np.nan),
                           read_dtype)
            lat = lon = None
            for name in LAT_CANDIDATES:
                if name in ds.variables:
                    lat = np.asarray(ds.variables[name][:], np.float64)
                    break
            for name in LON_CANDIDATES:
                if name in ds.variables:
                    lon = np.asarray(ds.variables[name][:], np.float64)
                    break
            for name in TIME_CANDIDATES:
                if name in ds.variables:
                    times = np.asarray(ds.variables[name][:], np.float64)
                    break

    nlat, nlon = u.shape[-2], u.shape[-1]
    if lat is None or lon is None:
        print(
            "WARNING: no lat/lon coordinate variables in the input; assuming "
            "a regular global grid (lat 90S..90N, lon 0E..360E)"
        )
    if lat is None:
        lat = -90.0 + np.arange(nlat) * (180.0 / (nlat - 1))
    if lon is None:
        lon = np.arange(nlon) * (360.0 / nlon)

    # Flip latitude to ascending.
    if lat[0] > lat[-1]:
        lat = lat[::-1]
        u = u[..., ::-1, :]
        v = v[..., ::-1, :]
    # (lat, lon) -> (lon, lat).
    u = np.moveaxis(u, -1, -2)
    v = np.moveaxis(v, -1, -2)
    # Normalize the longitude convention to 0-based ascending (0..360): the
    # samplers index the field stack as (lon mod 2*pi)/dx from column 0, so
    # a -180..180 input grid is rolled so its 0-degree column comes first
    # (exact: the grid is periodic in lon).
    lon_mod = np.asarray(lon, np.float64) % 360.0
    k = int(np.argmin(lon_mod))
    if k != 0 or lon_mod[0] != lon[0]:
        lon = np.roll(lon_mod, -k)
        u = np.roll(u, -k, axis=-2)
        v = np.roll(v, -k, axis=-2)
    out = (np.ascontiguousarray(u), np.ascontiguousarray(v),
           np.ascontiguousarray(lat) * deg2rad,
           np.ascontiguousarray(lon) * deg2rad)
    return out + (times,) if with_time else out


def basic_state_fields(bs: BasicState) -> Dict[str, np.ndarray]:
    """The 23-field diagnostic dict of the reference's basic-state output.

    For a time-varying basic state (4-D field stack) every entry carries a
    leading time axis (T, nlon, nlat). uxx, uyy, vxx and vyy are not in the
    stack: they are recomputed on the state's device, frame by frame.
    """
    nlon = bs.nlon
    f = bs.fields[..., :nlon, :, :]

    def second_derivs(u, v):
        return (g.gradient_xx(u, bs.dx), g.gradient_yy(u, bs.dy),
                g.gradient_xx(v, bs.dx), g.gradient_yy(v, bs.dy))

    u, v = f[..., 0], f[..., 1]
    if f.ndim == 4:
        derivs = [torch.stack(x) for x in zip(*(
            second_derivs(uu, vv) for uu, vv in zip(u, v)))]
    else:
        derivs = second_derivs(u, v)
    f = host(f)
    out = {name: f[..., i] for i, name in enumerate(FIELD_NAMES)}
    out.update(zip(("uxx", "uyy", "vxx", "vyy"), map(host, derivs)))
    out["q"] = host(bs.q)
    out["betam"] = host(bs.betam)
    out["KS"] = host(bs.ks)
    return out


def write_basic_state(bs: BasicState, path: str) -> None:
    """Write the basic-state diagnostics. Time-varying states also record
    bg_t0/bg_dt (seconds) so load_basic_state can restore the frame
    cadence."""
    fields = basic_state_fields(bs)
    lon_deg = host(bs.lon) * rad2deg
    lat_deg = host(bs.lat) * rad2deg
    time_varying = fields["u"].ndim == 3
    if _is_npz(path) or not HAVE_NETCDF:
        if not _is_npz(path):
            path = str(path) + ".npz"
        extra = ({"bg_t0": np.float64(bs.bg_t0), "bg_dt": np.float64(bs.bg_dt)}
                 if time_varying else {})
        np.savez_compressed(path, lon=lon_deg, lat=lat_deg, **fields, **extra)
        return
    with _nc.Dataset(path, "w", format="NETCDF4") as ds:  # pragma: no cover
        ds.createDimension("lon", bs.nlon)
        ds.createDimension("lat", bs.nlat)
        dims = ("lon", "lat")
        if time_varying:
            ds.createDimension("time", fields["u"].shape[0])
            tv = ds.createVariable("time", "f8", ("time",))
            tv[:] = bs.bg_t0 + np.arange(fields["u"].shape[0]) * bs.bg_dt
            tv.units = "seconds"
            ds.bg_t0 = float(bs.bg_t0)
            ds.bg_dt = float(bs.bg_dt)
            dims = ("time", "lon", "lat")
        for name, data, unit in (
            ("lon", lon_deg, "degrees_east"), ("lat", lat_deg, "degrees_north")
        ):
            var = ds.createVariable(name, "f8", (name,))
            var[:] = data
            var.units = unit
        units = {"u": "m/s", "v": "m/s", "q": "1/s",
                 "betam": "1/(m*s)", "KS": "1/m"}
        for name, data in fields.items():
            var = ds.createVariable(name, "f8", dims,
                                    zlib=True, complevel=4)
            var[:] = data
            var.units = units.get(name, "None")


def trajectory_arrays(traj) -> Dict[str, np.ndarray]:
    """The trajectory file's seven variables as numpy: rlon/rlat in
    degrees, rzwn, rmwn, ramp, rug, rvg, each (time, root, source, zwn)."""
    return {
        "rlon": host(traj.lon) * rad2deg,
        "rlat": host(traj.lat) * rad2deg,
        "rzwn": host(traj.kx),
        "rmwn": host(traj.ky),
        "ramp": host(traj.amp),
        "rug": host(traj.ug),
        "rvg": host(traj.vg),
    }


def write_trajectories(traj, path: str,
                       zwn: Optional[np.ndarray] = None) -> None:
    """Write ray trajectories: variables rlon/rlat (degrees), rzwn, rmwn,
    ramp, rug, rvg over dims (time, root, source, zwn)."""
    data = trajectory_arrays(traj)
    nt, nroot, nsource, nzwn = data["rlon"].shape
    if zwn is None:
        zwn = data["rzwn"][0, 0, 0, :]
    if _is_npz(path) or not HAVE_NETCDF:
        if not _is_npz(path):
            path = str(path) + ".npz"
        np.savez_compressed(
            path, zwn=np.asarray(zwn), source_index=np.arange(nsource),
            time_index=np.arange(nt), **data,
        )
        return
    with _nc.Dataset(path, "w") as ds:  # pragma: no cover
        ds.createDimension("zwn", nzwn)
        ds.createDimension("source", nsource)
        ds.createDimension("root", nroot)
        ds.createDimension("time", nt)
        ds.createVariable("zwn", "f8", ("zwn",))[:] = np.asarray(zwn)
        ds.createVariable("source_index", "i4", ("source",))[:] = np.arange(nsource)
        ds.createVariable("time_index", "i4", ("time",))[:] = np.arange(nt)
        units = {"rlon": "degrees", "rlat": "degrees",
                 "rzwn": "rad_per_meter*Rearth", "rug": "m s-1", "rvg": "m s-1"}
        for name, arr in data.items():
            var = ds.createVariable(name, "f8", ("time", "root", "source", "zwn"))
            var[:] = arr
            if name in units:
                var.units = units[name]


def load_basic_state(path: str, *, xcyclic: bool = True,
                     cal_dtype="float32", device="cuda") -> BasicState:
    """Rebuild a BasicState from a basic-state file written by
    write_basic_state (either package's): the stage-level restart, which
    skips the derivative precompute and injects the stored fields. The
    state goes to ``device`` (default: the card; pass "cpu" to run on the
    host)."""
    bg_attrs = {}
    if _is_npz(path):
        with np.load(path) as ds:
            data = {k: np.asarray(ds[k]) for k in ds.files}
        for k in ("bg_t0", "bg_dt"):
            if k in data:
                bg_attrs[k] = float(data.pop(k))
    else:
        if not HAVE_NETCDF:
            raise RuntimeError("netCDF4 not installed; use the .npz format")
        with _nc.Dataset(path) as ds:  # pragma: no cover
            data = {k: np.asarray(v[:]) for k, v in ds.variables.items()}
            for k in ("bg_t0", "bg_dt"):
                if hasattr(ds, k):
                    bg_attrs[k] = float(getattr(ds, k))

    lat = np.asarray(data["lat"], np.float64) * deg2rad
    lon = np.asarray(data["lon"], np.float64) * deg2rad
    stack = np.stack([data[name] for name in FIELD_NAMES], axis=-1)
    time_varying = stack.ndim == 4
    if time_varying and "bg_dt" not in bg_attrs:
        raise ValueError(
            "time-varying basic-state file lacks bg_t0/bg_dt metadata "
            "(written by an older version?); re-create it with "
            "write_basic_state or prepare_time_varying from the wind input"
        )
    if xcyclic:
        # Wrap column along LONGITUDE (axis 1 for (T, nlon, nlat, C) stacks).
        lon_axis = 1 if time_varying else 0
        wrap = np.take(stack, [0], axis=lon_axis)
        stack = np.concatenate([stack, wrap], axis=lon_axis)
    dtype = as_dtype(cal_dtype)

    def tensor(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    return BasicState(
        fields=tensor(stack), lon=tensor(lon), lat=tensor(lat),
        betam=tensor(data["betam"]), ks=tensor(data["KS"]),
        q=tensor(data["q"]), xcyclic=xcyclic, **bg_attrs,
    )


def load_trajectories(path: str) -> Dict[str, np.ndarray]:
    """Read a trajectory file written by write_trajectories (either
    format, either package)."""
    if _is_npz(path):
        with np.load(path) as ds:
            return {k: np.asarray(ds[k]) for k in ds.files}
    if not HAVE_NETCDF:
        raise RuntimeError("netCDF4 not installed; use the .npz format")
    with _nc.Dataset(path) as ds:  # pragma: no cover
        return {k: np.asarray(v[:]) for k, v in ds.variables.items()}


def write_wavenumber_maps(maps, bs: BasicState, zwn, path: str) -> None:
    """Write the grid-wide wavenumber diagnostics
    (``diagnostics.wavenumber.compute_wavenumber_maps``): mwn, rootnum, ug,
    vg, KS over (lon, lat, zwn, root).

    Time-varying products (5-D mwn from a 4-D BasicState) gain a leading
    'time' dimension with coordinates bg_t0 + i*bg_dt (seconds)."""
    data = {
        "mwn": host(maps.mwn),
        "rootnum": host(maps.rootnum),
        "ug": host(maps.ug),
        "vg": host(maps.vg),
        "KS": host(bs.ks),
    }
    lon_deg = host(bs.lon) * rad2deg
    lat_deg = host(bs.lat) * rad2deg
    time_varying = data["mwn"].ndim == 5
    if time_varying:
        data["time"] = (bs.bg_t0
                        + np.arange(data["mwn"].shape[0]) * bs.bg_dt)
    if _is_npz(path) or not HAVE_NETCDF:
        if not _is_npz(path):
            path = str(path) + ".npz"
        np.savez_compressed(path, lon=lon_deg, lat=lat_deg,
                            zwn=np.asarray(zwn), **data)
        return
    with _nc.Dataset(path, "w", format="NETCDF4") as ds:  # pragma: no cover
        nlon, nlat, nzwn, nroot = data["mwn"].shape[-4:]
        grid_dims = ("lon", "lat", "zwn")
        if time_varying:
            ds.createDimension("time", data["mwn"].shape[0])
            tv = ds.createVariable("time", "f8", ("time",))
            tv[:] = data["time"]
            tv.units = "seconds"
            grid_dims = ("time",) + grid_dims
        for name, n in (("lon", nlon), ("lat", nlat), ("zwn", nzwn),
                        ("root", nroot)):
            ds.createDimension(name, n)
        ds.createVariable("lon", "f8", ("lon",))[:] = lon_deg
        ds.createVariable("lat", "f8", ("lat",))[:] = lat_deg
        ds.createVariable("zwn", "f8", ("zwn",))[:] = np.asarray(zwn)
        for name in ("mwn", "ug", "vg"):
            ds.createVariable(name, "f8", grid_dims + ("root",),
                              zlib=True, complevel=4)[:] = data[name]
        ds.createVariable("rootnum", "i4", grid_dims)[:] = data["rootnum"]
        ks_dims = grid_dims[:1] + ("lon", "lat") if time_varying else (
            "lon", "lat")
        ds.createVariable("KS", "f8", ks_dims)[:] = data["KS"]
