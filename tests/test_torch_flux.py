"""The port's Li-Yang wave-ray flux against the JAX package's.

tests/test_flux_manual.py's cases with ``rwrt_tpu.diagnostics.flux`` as the
oracle: the same trajectories (numpy, made from a seed, float64 on the CPU,
carried to the port with ``convert``) through both packages. On the CPU the
port runs the flux kernel's plain version (``_accumulate_plain``,
``_region_plain``); the kernel itself is held to it on the card
(tests/test_torch_cuda_kernels.py).

The trajectories: rays drifting in random walks; rays circling east and
west past the three longitude circles (the clip at -360 / 720 degrees);
dead tails (NaN rows); rootless lanes (NaN amp, finite frozen position);
a NaN row 0 (the whole ray's unwrapped longitude NaN: JAX's int32 cast
takes it to bin 0); zero group velocity (the count weight's safe speed).

Bars: ``count`` maps equal; the other maps within 1e-12 of each map's
largest magnitude, NaN masks equal; masks, ``first_entry_step`` and
``n_passing`` equal; the region means within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwrt_tpu.diagnostics import flux as jflux
from rwrt_tpu.tracer import RayTrajectories as JTraj
from rwrt_tpu_torch import convert
from rwrt_tpu_torch.diagnostics import flux as pflux

BAR = 1e-12
NT, NS, NZ = 30, 6, 4
FIELDS = ("lon", "lat", "kx", "ky", "amp", "ug", "vg")


def synthetic(seed=0, nt=NT):
    """(nt, 3, NS, NZ) trajectories exercising every branch (see the module
    docstring), as a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (nt, 3, NS, NZ)
    lane = (1, 3, NS, NZ)
    step = rng.normal(0, 0.15, lane) + rng.normal(0, 0.05, shape)
    step[:, 0, 0, :] = 0.6    # east past 720 degrees
    step[:, 1, 0, :] = -0.5   # west past -360 degrees
    lon = np.cumsum(step, 0) + rng.uniform(0, 2 * np.pi, lane)
    lat = np.clip(np.cumsum(rng.normal(0, 0.05, shape), 0)
                  + rng.uniform(-1, 1, lane), -1.5, 1.5)
    d = dict(lon=lon, lat=lat, kx=rng.uniform(1, 7, shape),
             ky=rng.normal(0, 80, shape), amp=rng.normal(0, 2, shape),
             ug=rng.normal(0, 30, shape), vg=rng.normal(0, 20, shape))
    d["ug"][:, 2, 1, :] = 0.0
    d["vg"][:, 2, 1, :] = 0.0
    for a in d.values():
        a[nt * 2 // 3:, 0, 2, :] = np.nan   # dead tails
    d["amp"][:, 2, 3, :] = np.nan           # rootless
    d["lon"][0, 1, 4, :] = np.nan           # NaN row 0
    return d


def toy():
    """tests/test_flux_manual.py's hand case: one source, one zwn, 3 root
    slots, 4 steps (an eastward equatorial ray; a ray seeded in the box
    that dies at step 2; a rootless slot)."""
    shape = (4, 3, 1, 1)
    d = {k: np.full(shape, np.nan) for k in FIELDS}
    d["lon"][:, 0, 0, 0] = np.radians([0.0, 10.0, 20.0, 30.0])
    d["lat"][:, 0, 0, 0] = 0.0
    d["kx"][:, 0, 0, 0] = 3.0
    d["ky"][:, 0, 0, 0] = [1.0, 2.0, 50.0, 200.0]
    d["amp"][:, 0, 0, 0] = [1.0, 2.0, 4.0, 8.0]
    d["ug"][:, 0, 0, 0] = [30.0, 30.0, 30.0, 120.0]
    d["vg"][:, 0, 0, 0] = [0.0, 40.0, 0.0, 0.0]
    d["lon"][:2, 1, 0, 0] = np.radians([20.0, 21.0])
    d["lat"][:2, 1, 0, 0] = np.radians([5.0, 5.0])
    d["kx"][:2, 1, 0, 0] = 3.0
    d["ky"][:2, 1, 0, 0] = -1.0
    d["amp"][:2, 1, 0, 0] = 1.0
    d["ug"][:2, 1, 0, 0] = 10.0
    d["vg"][:2, 1, 0, 0] = 0.0
    return d


def both(d):
    return (JTraj(**{k: jnp.asarray(d[k]) for k in FIELDS}),
            convert.trajectories_from_numpy(d, device="cpu"))


def maps_close(want, got, exact_count=True):
    """Two WaveRayFlux: centers and count equal (with ``exact_count``),
    the other maps within BAR of each map's largest magnitude."""
    got = convert.flux_to_numpy(got)
    for k in want._fields:
        a, b = np.asarray(getattr(want, k)), got[k]
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        if k in ("lon_centers", "lat_centers") or (k == "count"
                                                    and exact_count):
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        scale = max(np.nanmax(np.abs(a), initial=0.0), 1e-300)
        np.testing.assert_allclose(b, a, rtol=0, atol=BAR * scale,
                                   equal_nan=True, err_msg=k)


#: Fun1's thresholds: none, the manual's two (speed bounds, the
#: abnormal-wavenumber cap), amplitude bounds.
THRESHOLDS = {"none": {},
              "fun1": dict(speed_min=10.0, speed_max=40.0, mwn_max=60.0),
              "amp": dict(amp_min=0.5, amp_max=3.0)}
#: Target boxes: plain, across the date line, full circles.
BOXES = {"plain": ((100.0, 140.0), (-20.0, 30.0)),
         "dateline": ((170.0, -160.0), (-30.0, 40.0)),
         "circle": ((0.0, 360.0), (-10.0, 10.0)),
         "circle_neg": ((-180.0, 180.0), (20.0, 60.0))}


@pytest.mark.parametrize("thr", list(THRESHOLDS))
@pytest.mark.parametrize("weight", ["count", "cg", "amp_cg"])
def test_wave_ray_flux_matches_jax(weight, thr):
    jt, pt_ = both(synthetic())
    kw = dict(weight=weight, nlon_bins=72, nlat_bins=30, **THRESHOLDS[thr])
    maps_close(jflux.wave_ray_flux(jt, **kw), pflux.wave_ray_flux(pt_, **kw))


@pytest.mark.parametrize("box", list(BOXES))
def test_region_flux_and_mask_match_jax(box):
    jt, pt_ = both(synthetic(1))
    lon_r, lat_r = BOXES[box]
    want = np.asarray(jflux.region_mask(jt, lon_r, lat_r))
    got = pflux.region_mask(pt_, lon_r, lat_r).numpy()
    np.testing.assert_array_equal(want, got)
    assert 0 < want.sum() < want.size
    kw = dict(lon_range=lon_r, lat_range=lat_r, weight="cg")
    maps_close(jflux.wave_ray_flux(jt, **kw), pflux.wave_ray_flux(pt_, **kw))


def test_threshold_filter_and_in_box_match_jax():
    jt, pt_ = both(synthetic(2))
    for kw in THRESHOLDS.values():
        np.testing.assert_array_equal(
            np.asarray(jflux.threshold_filter(jt, **kw)),
            pflux.threshold_filter(pt_, **kw).numpy())
    for lon_r, lat_r in BOXES.values():
        np.testing.assert_array_equal(
            np.asarray(jflux._in_box(jt, lon_r, lat_r)),
            pflux._in_box(pt_, lon_r, lat_r).numpy())


@pytest.mark.parametrize("split", [None, 1, 11])
def test_unwrap_matches_jax(split):
    """The continuous longitude, one-shot or chained through the carry at
    row ``split``: values (NaN rows, the clip, a NaN row 0) within BAR,
    and the carry."""
    lon = synthetic(3)["lon"]
    if split is None:
        want = np.asarray(jflux._unwrap_lon(jnp.asarray(lon)))
        got = pflux._unwrap_lon(torch.as_tensor(lon)).numpy()
    else:
        a, ca = jflux._unwrap_lon_block(jnp.asarray(lon[:split]))
        b, cb = jflux._unwrap_lon_block(jnp.asarray(lon[split:]), ca)
        want = np.concatenate([a, b])
        x, cx = pflux._unwrap_lon_block(torch.as_tensor(lon[:split]))
        y, cy = pflux._unwrap_lon_block(torch.as_tensor(lon[split:]), cx)
        got = torch.cat([x, y]).numpy()
        for u, v in zip(cb, cy):
            np.testing.assert_allclose(v.numpy(), np.asarray(u), rtol=0,
                                       atol=BAR * 4 * np.pi)
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=BAR * 4 * np.pi)
    assert np.nanmax(got) == pytest.approx(4 * np.pi)
    assert np.nanmin(got) == pytest.approx(-2 * np.pi)
    assert np.isnan(got[:, 1, 4]).all()


def test_nan_row0_bins_at_the_western_edge():
    """A ray whose row 0 is NaN has a NaN unwrapped longitude at every
    row; JAX casts it to int32 0 and the point lands in the first column.
    The port follows: its valid points all count in column 0."""
    d = synthetic(4)
    keep = np.zeros(d["lon"].shape[1:], bool)
    keep[1, 4, 0] = True
    sub = {k: np.where(keep[None], v, np.nan) for k, v in d.items()}
    jt, pt_ = both(sub)
    want = jflux.wave_ray_flux(jt, nlon_bins=72, nlat_bins=30)
    got = pflux.wave_ray_flux(pt_, nlon_bins=72, nlat_bins=30)
    maps_close(want, got)
    count = got.count.numpy()
    assert count[0].sum() == count.sum() == np.isfinite(
        d["amp"][1:, 1, 4, 0]).sum()


def test_toy_case_matches_jax_and_the_hand_count():
    jt, pt_ = both(toy())
    for kw in ({}, dict(speed_max=100.0, mwn_max=100.0),
               dict(lon_range=(15.0, 25.0), lat_range=(-10.0, 10.0))):
        want = jflux.wave_ray_flux(jt, nlon_bins=108, nlat_bins=18, **kw)
        got = pflux.wave_ray_flux(pt_, nlon_bins=108, nlat_bins=18, **kw)
        maps_close(want, got)
    assert float(pflux.wave_ray_flux(pt_).count.sum()) == 6.0


@pytest.mark.parametrize("region", [False, True])
@pytest.mark.parametrize("time_block", [1, 7, NT])
def test_chunked_matches_jax(time_block, region):
    """``wave_ray_flux_chunked`` on a host (numpy) history at time_block 1,
    7 and nt: float64 maps equal to JAX's; and to the one-shot result."""
    d = synthetic(5)
    jt = JTraj(**{k: jnp.asarray(d[k]) for k in FIELDS})
    host = pflux.RayTrajectories(**d)  # numpy fields, as from a memmap
    kw = dict(nlon_bins=72, nlat_bins=30, mwn_max=90.0)
    if region:
        kw.update(lon_range=(100.0, 300.0), lat_range=(-40.0, 40.0))
    want = jflux.wave_ray_flux_chunked(jt, time_block=time_block, **kw)
    got = pflux.wave_ray_flux_chunked(host, time_block=time_block,
                                      device="cpu", **kw)
    assert got.count.dtype == torch.float64
    maps_close(want, got)
    one = pflux.wave_ray_flux(convert.trajectories_from_numpy(
        d, device="cpu"), **kw)
    maps_close(one, got)


@pytest.mark.parametrize("time_block", [None, 5])
def test_ensemble_flux_statistics_matches_jax(time_block):
    members = [both(synthetic(10 + i)) for i in range(3)]
    kw = dict(nlon_bins=36, nlat_bins=18, weight="count")
    want = jflux.ensemble_flux_statistics([m[0] for m in members],
                                          time_block=time_block, **kw)
    got = pflux.ensemble_flux_statistics([m[1] for m in members],
                                         time_block=time_block,
                                         device="cpu", **kw)
    for w, g in zip(want, got):
        maps_close(w, g, exact_count=False)


@pytest.mark.parametrize("sources", [False, True])
@pytest.mark.parametrize("time_block", [None, 1, 4])
def test_region_statistics_matches_jax(time_block, sources):
    d = synthetic(6)
    jt, pt_ = both(d)
    kw = dict(time_block=time_block)
    if sources:
        kw.update(source_lon=np.linspace(0, 5, NS),
                  source_lat=np.linspace(-1, 1, NS))
    for lon_r, lat_r in BOXES.values():
        want = jflux.region_statistics(jt, lon_r, lat_r, 7200.0, **kw)
        got = pflux.region_statistics(pt_, lon_r, lat_r, 7200.0, **kw)
        assert got.n_passing == want.n_passing
        np.testing.assert_array_equal(got.first_entry_step,
                                      want.first_entry_step)
        for k in ("mean_entry_time", "mean_speed"):
            a, b = getattr(want, k), getattr(got, k)
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= BAR * abs(
                a), k
        for k in ("source_lon", "source_lat"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_cpu_runs_the_plain_version_and_bad_inputs_raise():
    """On CPU tensors no kernel launches; an unknown weight and a bad
    time_block raise as in the JAX package."""
    _, pt_ = both(synthetic())
    before = (pflux.LAUNCHES, pflux.REGION_LAUNCHES)
    pflux.wave_ray_flux(pt_, lon_range=(0, 90), lat_range=(0, 45))
    assert (pflux.LAUNCHES, pflux.REGION_LAUNCHES) == before
    with pytest.raises(ValueError, match="unknown weight"):
        pflux.wave_ray_flux(pt_, weight="nope")
    with pytest.raises(ValueError, match="time_block"):
        pflux.wave_ray_flux_chunked(pt_, time_block=0, device="cpu")
    with pytest.raises(ValueError, match="time_block"):
        pflux.region_statistics(pt_, (0, 90), (0, 45), 7200.0, time_block=0)
