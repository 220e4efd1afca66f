"""Port parity: the spectral sampler and its fit.

The port's plain ``sample_spectral`` against the JAX package's
``sample_spectral`` and its Pallas kernel ``sample_spectral_pallas`` run in
interpret mode on the CPU, at tests/test_spectral_sample.py's bars: 1e-12
in float64, 1e-5 in float32, NaN rows for |lat| > pi/2 and NaN positions,
and every operand dtype (``matmul_dtype``) both packages name, rounded
once as JAX rounds it (``round_operands``).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu.ops import spectral_sample as jspec
from rwrt_tpu_torch import convert
from rwrt_tpu_torch.ops import spectral_sample as tspec


def grid(nlon, nlat):
    return (np.arange(nlon) * 2 * np.pi / nlon,
            np.linspace(-np.pi / 2, np.pi / 2, nlat))


def fits(dtype, m_max=None, l_max=None, seed=6):
    nlon, nlat = 36, 19
    lon, lat = grid(nlon, nlat)
    fields = np.random.default_rng(seed).normal(size=(nlon, nlat, 12))
    fields = fields.astype(dtype)
    kw = dict(lon=lon, lat=lat, m_max=m_max, l_max=l_max)
    return jspec.fit_spectral(fields, **kw), tspec.fit_spectral(fields, **kw)


def points(dtype, n=700, seed=7):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-1.0, 7.0, n)
    lat = rng.uniform(-1.6, 1.6, n)      # some |lat| > pi/2
    lon[:7] = np.nan
    return lon.astype(dtype), lat.astype(dtype)


@pytest.mark.parametrize("trunc", [(None, None), (9, 11)])
def test_fit_matches_jax(trunc):
    ref, out = fits(np.float64, *trunc)
    np.testing.assert_allclose(out.coeffs.numpy(), np.asarray(ref.coeffs),
                               rtol=0, atol=1e-12)
    assert float(out.lat0) == float(ref.lat0)
    assert (out.m_max, out.l_max, out.num_fields) == (ref.m_max, ref.l_max,
                                                      ref.num_fields)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("against", ["sample_spectral",
                                     "sample_spectral_pallas"])
def test_sample_matches_jax(dtype, tol, against):
    ref_fit, out_fit = fits(dtype)
    lon, lat = points(dtype)
    kw = dict(interpret=True) if against.endswith("pallas") else {}
    ref = np.asarray(getattr(jspec, against)(
        ref_fit, jnp.asarray(lon), jnp.asarray(lat), **kw))
    out = tspec.sample_spectral(out_fit, torch.as_tensor(lon),
                                torch.as_tensor(lat)).numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    assert np.isnan(out[np.abs(lat) > np.pi / 2]).all()
    assert np.isnan(out[:7]).all()
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("against", ["sample_spectral",
                                     "sample_spectral_pallas"])
def test_bf16_operands_match_jax(against):
    ref_fit, out_fit = fits(np.float32)
    lon, lat = points(np.float32)
    kw = dict(interpret=True) if against.endswith("pallas") else {}
    ref = np.asarray(getattr(jspec, against)(
        ref_fit, jnp.asarray(lon), jnp.asarray(lat),
        matmul_dtype=jnp.bfloat16, **kw))
    out = tspec.sample_spectral(out_fit, torch.as_tensor(lon),
                                torch.as_tensor(lat),
                                matmul_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # bf16 operands stay within bf16 error of the float32 result.
    f32 = tspec.sample_spectral(out_fit, torch.as_tensor(lon),
                                torch.as_tensor(lat)).numpy()
    scale = np.nanmax(np.abs(f32))
    assert np.nanmax(np.abs(out - f32)) / scale < 0.03


def test_fit_of_basic_state_is_exact_at_grid_points(jet_field):
    """Full truncation reproduces the stack on its own grid; the fit of a
    converted JAX state equals the JAX fit."""
    u, v, lat, lon = jet_field
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    bst = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()},
        device="cpu")
    ref, out = jspec.fit_spectral(bsj), tspec.fit_spectral(bst)
    np.testing.assert_allclose(out.coeffs.numpy(), np.asarray(ref.coeffs),
                               rtol=0, atol=1e-9)
    glon, glat = np.meshgrid(lon, lat[1:-1], indexing="ij")
    vals = tspec.sample_spectral(out, torch.as_tensor(glon.ravel()),
                                 torch.as_tensor(glat.ravel())).numpy()
    stack = bst.fields.numpy()[:-1, 1:-1].reshape(-1, 18)
    scale = np.abs(stack).max(axis=0)
    assert (np.abs(vals - stack) / scale).max() < 1e-10


def test_cuda_wrapper_on_cpu_is_the_plain_version():
    _, out_fit = fits(np.float64)
    lon, lat = points(np.float64)
    before = tspec.LAUNCHES
    a = tspec.sample_spectral_cuda(out_fit, torch.as_tensor(lon),
                                   torch.as_tensor(lat))
    b = tspec.sample_spectral(out_fit, torch.as_tensor(lon),
                              torch.as_tensor(lat))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert tspec.LAUNCHES == before


@pytest.mark.parametrize("fn", ["sample_spectral", "sample_spectral_cuda"])
def test_bf16_operands_over_float64_match_jax_pallas(fn):
    """bf16 operands with float64 coefficients (sums in float64), the plain
    version and the kernel wrapper's CPU path, against the JAX kernel."""
    ref_fit, out_fit = fits(np.float64)
    lon, lat = points(np.float64, n=300)
    ref = np.asarray(jspec.sample_spectral_pallas(
        ref_fit, jnp.asarray(lon), jnp.asarray(lat),
        matmul_dtype=jnp.bfloat16, interpret=True))
    out = getattr(tspec, fn)(out_fit, torch.as_tensor(lon),
                             torch.as_tensor(lat),
                             matmul_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    scale = np.nanmax(np.abs(ref), axis=0)
    assert np.nanmax(np.abs(out - ref) / scale) <= 1e-12


def test_cuda_wrapper_matmul_dtypes():
    """Every served operand dtype takes the plain route on the CPU (the
    coefficient dtype itself is None); a non-floating dtype, and a floating
    one JAX does not take, raise ValueError naming the served set, on the
    CPU as they would on the card."""
    _, out_fit = fits(np.float64)
    lon, lat = (torch.as_tensor(x) for x in points(np.float64, n=50))
    a = tspec.sample_spectral_cuda(out_fit, lon, lat,
                                   matmul_dtype=torch.float64)
    b = tspec.sample_spectral(out_fit, lon, lat)
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    for mm in tspec.OPERAND_DTYPES:
        a = tspec.sample_spectral_cuda(out_fit, lon, lat, matmul_dtype=mm)
        b = tspec.sample_spectral(out_fit, lon, lat, matmul_dtype=mm)
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), mm
    for bad in (torch.int8, torch.int32, torch.bool, torch.complex64,
                "float16"):
        with pytest.raises(ValueError, match="floating"):
            tspec.sample_spectral_cuda(out_fit, lon, lat, matmul_dtype=bad)
    with pytest.raises(ValueError, match="float8_e4m3fnuz"):
        tspec.sample_spectral_cuda(out_fit, lon, lat,
                                   matmul_dtype=torch.float8_e8m0fnu)
    assert len(tspec.OPERAND_DTYPES) == 8


#: Every floating dtype both packages name: the port's served set.
JAX_OPERANDS = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
                torch.float32: jnp.float32, torch.float64: jnp.float64,
                torch.float8_e4m3fn: jnp.float8_e4m3fn,
                torch.float8_e5m2: jnp.float8_e5m2,
                torch.float8_e4m3fnuz: jnp.float8_e4m3fnuz,
                torch.float8_e5m2fnuz: jnp.float8_e5m2fnuz}
BARS = {np.float64: 1e-12, np.float32: 1e-5}


@functools.cache
def pallas_sample(dtype, mm, scale=1.0):
    """The JAX kernel (interpret mode) on ``fits(dtype)`` times ``scale``
    at ``points(dtype, n=300)``, with ``mm`` operands; and the port's fit."""
    ref_fit, out_fit = fits(dtype)
    ref_fit = ref_fit._replace(coeffs=ref_fit.coeffs * scale)
    out_fit = out_fit._replace(coeffs=out_fit.coeffs * scale)
    lon, lat = points(dtype, n=300)
    ref = np.asarray(jspec.sample_spectral_pallas(
        ref_fit, jnp.asarray(lon), jnp.asarray(lat),
        matmul_dtype=JAX_OPERANDS[mm], interpret=True))
    return ref, out_fit, lon, lat


def assert_matches(out, ref, bar):
    """Non-finite positions equal (NaN and inf apart); finite ones within
    ``bar`` of each channel's max |value| over them."""
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_array_equal(np.isinf(ref), np.isinf(out))
    np.testing.assert_array_equal(out[np.isinf(out)], ref[np.isinf(ref)])
    fin = np.isfinite(ref)
    scale = np.where(fin, np.abs(ref), 0.0).max(axis=0)
    diff = np.where(fin, np.abs(out - np.where(fin, ref, 0.0)), 0.0)
    assert (diff <= bar * scale).all(), (diff / np.maximum(scale, 1e-300)
                                         ).max()


@pytest.mark.parametrize("fn", ["sample_spectral", "sample_spectral_cuda"])
@pytest.mark.parametrize("mm", list(JAX_OPERANDS), ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
def test_operand_dtypes_match_jax_pallas(dtype, mm, fn):
    """Each served (coefficient dtype, matmul_dtype) pair: the JAX kernel
    takes it (interpret mode), and the plain version and the kernel
    wrapper's CPU route agree with it, NaN masks equal, at the bars."""
    ref, out_fit, lon, lat = pallas_sample(dtype, mm)
    assert ref.dtype == dtype
    out = getattr(tspec, fn)(out_fit, torch.as_tensor(lon),
                             torch.as_tensor(lat), matmul_dtype=mm).numpy()
    assert out.dtype == dtype
    assert np.isnan(out[:7]).all()
    assert_matches(out, ref, BARS[dtype])


@pytest.mark.parametrize("scale", [3e3, 3e5])
@pytest.mark.parametrize("mm", [torch.float16, torch.float8_e4m3fn,
                                torch.float8_e5m2, torch.float8_e4m3fnuz,
                                torch.float8_e5m2fnuz], ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
def test_operand_overflow_matches_jax_pallas(dtype, mm, scale):
    """Coefficients past the format's largest value: inf (float16,
    float8_e5m2) or NaN (the others) in both packages, and the samples'
    non-finite positions equal."""
    ref, out_fit, lon, lat = pallas_sample(dtype, mm, scale)
    rounded = tspec.round_operands(out_fit.coeffs, mm)
    out = tspec.sample_spectral(out_fit, torch.as_tensor(lon),
                                torch.as_tensor(lat), matmul_dtype=mm)
    assert_matches(out.numpy(), ref, BARS[dtype])
    if scale == 3e5:
        assert not torch.isfinite(rounded).all()
        assert not np.isfinite(ref[7:]).all()


#: float64 values that torch's casts round twice (through float32), to
#: float16 and float8_e4m3fn, and what one rounding gives (JAX, numpy).
TIES = {torch.float16: (1 + 2.0 ** -11 + 2.0 ** -40, 1.0009765625),
        torch.float8_e4m3fn: (1 + 2.0 ** -4 + 2.0 ** -40, 1.125)}


@pytest.mark.parametrize("mm", list(TIES), ids=str)
def test_operands_round_once(mm):
    x, want = TIES[mm]
    assert torch.tensor([x], dtype=torch.float64).to(mm).double() == 1.0
    got = tspec.round_operands(torch.tensor([x], dtype=torch.float64), mm)
    assert got.dtype == torch.float64 and float(got[0]) == want
    # A one-coefficient float64 fit through both packages' samplers.
    c = np.full((1, 1, 1), x)
    sbg = tspec.SpectralBackground(torch.as_tensor(c),
                                   torch.tensor(0.0, dtype=torch.float64))
    zero = torch.zeros(1, dtype=torch.float64)
    out = tspec.sample_spectral(sbg, zero, zero, matmul_dtype=mm)
    assert float(out[0, 0]) == want
    ref = jspec.sample_spectral_pallas(
        jspec.SpectralBackground(jnp.asarray(c), jnp.asarray(0.0)),
        jnp.zeros(1), jnp.zeros(1), matmul_dtype=JAX_OPERANDS[mm],
        interpret=True)
    assert float(ref[0, 0]) == want


def sweep(dtype, p, emin, big, n=60_000, seed=9):
    """Values that test a rounding to a format of ``p`` significand bits,
    least normal exponent ``emin`` and largest value ``big``: uniform over
    [-1, 1] and over twice the range, log-uniform magnitudes down past the
    subnormals, exact ties at every exponent and a hair to each side of
    them, the specials and the overflow edge."""
    rng = np.random.default_rng(seed)
    sign = rng.choice([-1.0, 1.0], n)
    k = rng.integers(0, 2 ** p, n) + 0.5
    step = 2.0 ** rng.integers(emin - p, 8, n).astype(np.float64)
    ties = sign * k * step
    eps = 2.0 ** -40 if dtype == np.float64 else 2.0 ** -20
    x = np.concatenate([
        rng.uniform(-1, 1, n), rng.uniform(-2 * big, 2 * big, n),
        sign * 2.0 ** rng.uniform(emin - p - 4, 1, n),
        ties, ties * (1 + eps), ties * (1 - eps),
        [0.0, -0.0, np.inf, -np.inf, np.nan, big, -big, big * (1 + eps),
         big * 1.03, big * 1.07, -big * 1.07, 2.0 ** (emin - p),
         -(2.0 ** (emin - p)), 1.5 * 2.0 ** (emin - p)]])
    return x.astype(dtype)


def same_values(a, b):
    """Equal to the bit (the sign of zero too), NaN where NaN."""
    nan = np.isnan(a)
    return (np.array_equal(nan, np.isnan(b))
            and np.array_equal(np.where(nan, 0, a).view(np.uint64
                               if a.dtype == np.float64 else np.uint32),
                               np.where(nan, 0, b).view(np.uint64
                               if b.dtype == np.float64 else np.uint32)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("mm", list(tspec._FORMATS), ids=str)
def test_round_operands_sweep(mm, dtype):
    """``round_operands`` against JAX's cast (and, for float64 to float16,
    numpy's): bitwise, NaN where NaN, over ``sweep``'s values."""
    p, emin, big, _, _ = tspec._FORMATS[mm]
    x = sweep(dtype, p, emin, big)
    got = tspec.round_operands(torch.from_numpy(x), mm).numpy()
    jx = JAX_OPERANDS[mm]
    ref = np.asarray(jnp.asarray(x).astype(jx).astype(x.dtype))
    assert same_values(got, ref)
    if mm == torch.float16 and dtype == np.float64:
        with np.errstate(over="ignore"):
            assert same_values(got, x.astype(np.float16).astype(x.dtype))
    # Every result is a value of the format, held exactly.
    fmt = np.dtype(jx)
    fin = np.isfinite(got)
    assert np.array_equal(got[fin].astype(fmt).astype(x.dtype), got[fin])


def test_tf32_round_is_nearest_ties_away():
    ulp = 2.0 ** -10                    # tf32 spacing in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 3 * ulp / 2, 3.0e-3, 0.0], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp]
    got = tspec.tf32_round(x)
    assert got[:4].tolist() == want
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(float(got[4]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert float(got[5]) == 0.0


def unpack(packed):
    """pack_coeffs' tiles back to (C, P, G * GROUP, Kp): the coefficients
    channel-major, as the kernel's MMAs see them."""
    c, g, nkc, p, group, _ = packed.shape
    x = packed[..., :tspec.KC].permute(0, 3, 1, 4, 2, 5)
    return x.reshape(c, p, g * group, nkc * tspec.KC)


PACK_CASES = {"float64": None, "float32": None,
              "float32_bf16": torch.bfloat16,
              "float64_bf16": torch.bfloat16,
              "float32_float16": torch.float16,
              "float64_float16": torch.float16,
              "float64_float32": torch.float32,
              "float32_float64": torch.float64}
for _f8 in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
            "float8_e5m2fnuz"):
    PACK_CASES["float32_" + _f8] = PACK_CASES["float64_" + _f8] = getattr(
        torch, _f8)


@pytest.mark.parametrize("trunc", [(None, None), (0, None), (None, 1),
                                   (9, 11)])
@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_coeffs_round_trips(trunc, case):
    dtype = torch.float64 if case.startswith("float64") else torch.float32
    mm = PACK_CASES[case]
    coeffs = fits(np.float64, *trunc)[1].coeffs.to(dtype)
    mp, l_max, c = coeffs.shape
    kp, lp = tspec.packed_dims(mp, l_max)
    assert kp % tspec.KC == 0 and mp <= kp < mp + tspec.KC
    assert lp % 8 == 0 and l_max <= lp < l_max + 8
    packed = tspec.pack_coeffs(coeffs, mm)
    split = dtype == torch.float32 and tspec.operand_case(dtype, mm) == 0
    planes = 2 if split else 1
    groups = -(-l_max // tspec.GROUP)
    narrow = mm is not None and mm != torch.float16 and mm.itemsize < 4
    assert packed.dtype == (torch.bfloat16 if dtype == torch.float32
                            and narrow else dtype)
    assert packed.shape == (c, groups, kp // tspec.KC, planes, tspec.GROUP,
                            tspec.tile_row(packed.dtype))
    assert packed.is_contiguous()
    # Zero in the row pad, past Mp and past L, in every plane.
    assert not packed[..., tspec.KC:].ne(0).any()
    full = unpack(packed)
    assert not full[..., mp:].ne(0).any()
    assert not full[:, :, l_max:].ne(0).any()
    # hi + lo summed exactly (float64) returns the coefficients.
    back = full.to(torch.float64).sum(dim=1)[:, :l_max, :mp]
    back = back.permute(2, 1, 0)
    if split:
        assert (full.view(torch.int32) & 0x1FFF).eq(0).all()
        x = coeffs.double()
        assert ((back - x).abs() <= x.abs() * 2.0 ** -22).all()
    else:
        # The operands rounded once, held exactly in the plane's dtype.
        want = tspec.round_operands(coeffs, mm)
        assert torch.equal(back.to(dtype), want)
        if mm is not None and mm.itemsize < dtype.itemsize:
            assert not torch.equal(want, coeffs)
        if mm == torch.float16 and dtype == torch.float32:
            assert (full.view(torch.int32) & 0x1FFF).eq(0).all()


def climatology_fit(dtype):
    """The 144 x 73 climatology background's 18-channel stack (the one
    chip_smoke.py samples), prepared and fitted by both packages."""
    nlon, nlat = 144, 73
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = (25.0 * np.cos(lat)[None, :] ** 2
         + 30.0 * np.exp(-(((np.degrees(lat)[None, :] - 35.0) / 12.0) ** 2))
         + 6.0 * np.cos(3 * lon)[:, None] * np.cos(lat)[None, :] ** 2)
    v = 4.0 * np.sin(2 * lon)[:, None] * np.cos(lat)[None, :]
    name = "float64" if dtype == np.float64 else "float32"
    bsj = rt.prepare(u, v, lat, lon, cal_dtype=name)
    bst = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()},
        device="cpu")
    return jspec.fit_spectral(bsj), tspec.fit_spectral(bst)


def emulate_kernel(sbg, lon, lat, matmul_dtype=None, passes=3):
    """``csrc/spectral.cu``'s algorithm in plain torch on the CPU: the
    packed coefficient tiles, the basis as the kernel's prologue
    builds it (zero past Mp and L, rounded to ``matmul_dtype``), the m
    contraction per channel as the kernel's MMAs take it (3xTF32 from
    hi/lo splits in float32 with no rounding, or one tf32 pass with
    ``passes=1``), then the per-row latitude reduction."""
    coeffs = sbg.coeffs
    dtype = coeffs.dtype
    mp, l_max, _ = coeffs.shape
    kp, lp = tspec.packed_dims(mp, l_max)
    packed = unpack(tspec.pack_coeffs(coeffs, matmul_dtype)).to(dtype)
    packed = packed[:, :, :lp]
    pad = torch.nn.functional.pad
    a = pad(tspec._basis_lon(lon, (mp - 1) // 2), (0, kp - mp))
    blat = pad(tspec._basis_lat(lat, sbg.lat0, l_max), (0, lp - l_max))
    bt = packed.transpose(2, 3)                    # (C, P, Kp, Lp)
    if tspec.operand_case(dtype, matmul_dtype):
        w = tspec.round_operands(a, matmul_dtype) @ bt[:, 0]
    elif dtype == torch.float32:
        hi = tspec.tf32_round(a)
        lo = tspec.tf32_round(a - hi)
        w = hi @ bt[:, 0]
        if passes == 3:
            w = lo @ bt[:, 0] + hi @ bt[:, 1] + w
    else:
        w = a @ bt[:, 0]                           # (C, R, Lp)
    out = (w * blat).sum(dim=-1).T
    return torch.where((lat.abs() <= 0.5 * np.pi)[:, None], out,
                       torch.full_like(out, float("nan")))


@pytest.mark.parametrize("case,bar", [("float32", 1e-5),
                                      ("float32_bf16", 1e-5),
                                      ("float64", 1e-12),
                                      ("float64_bf16", 1e-12),
                                      ("float32_float16", 1e-5),
                                      ("float32_float8_e4m3fn", 1e-5),
                                      ("float64_float16", 1e-12),
                                      ("float64_float32", 1e-12),
                                      ("float64_float8_e5m2", 1e-12)])
def test_kernel_algorithm_meets_bars_on_climatology(case, bar):
    """The kernel's arithmetic, emulated, against JAX ``sample_spectral`` on
    the 144 x 73 climatology fit at 3000 points: 3xTF32 meets the float32
    bar (max |diff| / channel max), where one TF32 pass does not; rounded
    operands meet it too, with the non-finite channels of an overflowing
    cast (e4m3fn past 448) where JAX has them."""
    np_dtype = np.float64 if case.startswith("float64") else np.float32
    mm = PACK_CASES[case]
    ref_fit, out_fit = climatology_fit(np_dtype)
    assert tuple(out_fit.coeffs.shape) == (145, 73, 18)
    lon, lat = points(np_dtype, n=3000, seed=8)
    ref = np.asarray(jspec.sample_spectral(
        ref_fit, jnp.asarray(lon), jnp.asarray(lat),
        matmul_dtype=None if mm is None else JAX_OPERANDS[mm]))
    lon_t, lat_t = torch.as_tensor(lon), torch.as_tensor(lat)
    out = emulate_kernel(out_fit, lon_t, lat_t, mm).numpy()
    assert_matches(out, ref, bar)
    if mm == torch.float8_e4m3fn:
        assert np.isnan(ref).all(axis=0).any()
    if case == "float32":
        scale = np.nanmax(np.abs(ref), axis=0)
        one = emulate_kernel(out_fit, lon_t, lat_t, passes=1).numpy()
        assert np.nanmax(np.abs(one - ref) / scale) > bar


def test_mercator_spectral_matches_jax():
    ref_fit, out_fit = fits(np.float64)
    lon, lat = points(np.float64)
    ref = np.asarray(jspec.sample_mercator_spectral(
        ref_fit, jnp.asarray(lon), jnp.asarray(lat)))
    out = tspec.sample_mercator_spectral(out_fit, torch.as_tensor(lon),
                                         torch.as_tensor(lat)).numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
