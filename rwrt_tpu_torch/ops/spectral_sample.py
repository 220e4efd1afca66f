"""Tensor-product spectral background sampling.

Port of ``rwrt_tpu/ops/spectral_sample.py`` (static fits). Each field channel
is expanded as

    f(lon, lat) = sum_{m=0}^{M} sum_{l=0}^{L-1}
        [a_{ml} cos(m lon) + b_{ml} sin(m lon)] * cos(l * (lat - lat0))

which is exact on the stack's own grid at full truncation. Evaluation at R
points is a (R, Mp) @ (Mp, L*C) product followed by a latitude contraction.

``fit_spectral`` is host numpy, carried over from the JAX package.
``sample_spectral`` is the plain PyTorch evaluation. ``sample_spectral_cuda``
replaces the JAX package's Pallas kernel ``sample_spectral_pallas``: on a
CUDA tensor it repacks the coefficients in one launch of the packing
kernel (``pack_on_card``; its plain version ``pack_coeffs``) and launches
``csrc/spectral.cu``, which builds the basis rows in shared memory and
contracts them on the tensor cores without materializing (R, Mp) or
(R, L*C); on a CPU tensor it runs ``sample_spectral``. ``LAUNCHES`` counts
sampler launches, ``PACK_LAUNCHES`` packing launches. Both take the
product's operands in any ``matmul_dtype`` of ``OPERAND_DTYPES``, rounded
once as JAX rounds them (``round_operands``), with sums in the
coefficients' dtype; each case runs on a tensor-core format whose
products of the rounded operands are exact (``_operand_type``). A
time-varying stack is fitted frame by frame (``fit_spectral_time``), and
``lerp_coeffs`` blends the fit to one time, which the same sampler (and
kernel) then evaluates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rwrt_tpu_torch import kernels
from rwrt_tpu_torch.constants import pi
from rwrt_tpu_torch.models.basic_state import as_dtype
from rwrt_tpu_torch.ops.interp import _cell_index, mercator_transform

#: Number of spectral kernel launches in this process.
LAUNCHES = 0
#: Number of packing kernel launches (``pack_on_card``) in this process.
PACK_LAUNCHES = 0


class SpectralBackground(NamedTuple):
    """Spectral coefficients of the background-field stack.

    coeffs: (Mp, L, C) with Mp rows [cos 0, cos 1..cos M, sin 1..sin M],
        or (T, Mp, L, C) for a time-varying fit (``fit_spectral_time``).
    lat0: 0-d tensor, latitude of the first grid row (radians).
    """

    coeffs: torch.Tensor
    lat0: torch.Tensor

    @property
    def m_max(self) -> int:
        return (self.coeffs.shape[-3] - 1) // 2

    @property
    def l_max(self) -> int:
        return self.coeffs.shape[-2]

    @property
    def num_fields(self) -> int:
        return self.coeffs.shape[-1]


def fit_spectral(bs_or_fields, *, m_max=None, l_max=None, lon=None, lat=None,
                 xcyclic=None, dtype=None, device=None) -> SpectralBackground:
    """Fit the tensor-product spectral representation of a field stack.

    Args:
      bs_or_fields: a ``BasicState`` (its ``fields`` stack is fitted, the
        wrap column dropped when ``xcyclic``; a time-varying one goes to
        ``fit_spectral_time``) or a raw (nlon, nlat, C) array.
      m_max: zonal truncation, default nlon//2 (exact).
      l_max: number of latitude cosine modes, default nlat (exact).
      lon, lat: grid coordinates in radians for a raw array.
      xcyclic: whether the last lon column is a cyclic wrap duplicate.
      dtype: coefficient dtype; defaults to the stack's dtype.
      device: where the coefficients go; defaults to the stack's device.

    The fit runs on the host in float64 (rFFT in lon, DCT-I in lat).
    """
    if hasattr(bs_or_fields, "fields"):
        bs = bs_or_fields
        fields = bs.fields.detach().cpu().numpy().astype(np.float64)
        if xcyclic is None:
            xcyclic = bool(bs.xcyclic)
        lon = bs.lon.detach().cpu().numpy().astype(np.float64)
        lat = bs.lat.detach().cpu().numpy().astype(np.float64)
        if dtype is None:
            dtype = bs.fields.dtype
        if device is None:
            device = bs.fields.device
        if fields.ndim == 4:
            # A time-varying state: each frame is fitted (the wrap column
            # is per frame).
            return fit_spectral_time(fields, m_max=m_max, l_max=l_max,
                                     lon=lon, lat=lat, xcyclic=xcyclic,
                                     dtype=dtype, device=device)
    else:
        arr = (bs_or_fields.detach().cpu().numpy()
               if torch.is_tensor(bs_or_fields) else np.asarray(bs_or_fields))
        fields = arr.astype(np.float64)
        if dtype is None:
            dtype = arr.dtype
        xcyclic = bool(xcyclic) if xcyclic is not None else False
        if fields.ndim == 4:
            raise ValueError("4-D stacks are time-varying; use "
                             "fit_spectral_time (or pass a BasicState)")
    dtype = as_dtype(dtype)
    if fields.ndim == 2:
        fields = fields[..., None]
    if xcyclic:
        fields = fields[:-1]
    n, nlat = fields.shape[0], fields.shape[1]
    lon0 = 0.0 if lon is None else float(lon[0])
    lat0 = -0.5 * pi if lat is None else float(lat[0])

    if m_max is None:
        m_max = n // 2
    if l_max is None:
        l_max = nlat
    if not (0 <= m_max <= n // 2):
        raise ValueError(f"m_max must be in [0, nlon//2={n // 2}]; got {m_max}")
    if not (1 <= l_max <= nlat):
        raise ValueError(f"l_max must be in [1, nlat={nlat}]; got {l_max}")

    # Longitude: complex coefficients with the grid-origin phase folded in.
    X = np.fft.rfft(fields, axis=0) / n
    marr = np.arange(X.shape[0])
    X = X * np.exp(-1j * marr * lon0)[:, None, None]
    a = 2.0 * X.real
    b = -2.0 * X.imag
    a[0] *= 0.5
    if n % 2 == 0:
        # Nyquist column: no doubling; the phase fold rotates it into the
        # sin component too.
        a[n // 2] *= 0.5
        b[n // 2] *= 0.5

    rows = np.concatenate([a[: m_max + 1], b[1: m_max + 1]], axis=0)

    # Latitude: DCT-I analysis (theta_j = j*pi/(nlat-1), endpoints in).
    from scipy.fft import dct

    G = dct(rows, type=1, axis=1) / (nlat - 1)
    G[:, 0] *= 0.5
    G[:, -1] *= 0.5
    coeffs = G[:, :l_max]

    return SpectralBackground(
        coeffs=torch.as_tensor(coeffs).to(device=device, dtype=dtype),
        lat0=torch.tensor(lat0, dtype=dtype, device=device),
    )


def fit_spectral_time(frames, *, m_max=None, l_max=None, lon=None, lat=None,
                      xcyclic=False, dtype=None,
                      device=None) -> SpectralBackground:
    """Fit a time-varying stack frame by frame: frames (T, nlon, nlat, C)
    -> coeffs (T, Mp, L, C). The fit is linear, so blending coefficient
    frames (``lerp_coeffs``) equals fitting the blended fields. Arguments as
    ``fit_spectral``'s for a raw array; device defaults to the frames'
    (the host for a numpy array)."""
    if torch.is_tensor(frames):
        if device is None:
            device = frames.device
        frames = frames.detach().cpu().numpy()
    if dtype is None:
        dtype = np.asarray(frames).dtype
    frames = np.asarray(frames, dtype=np.float64)
    if frames.ndim != 4:
        raise ValueError(f"frames must be (T, nlon, nlat, C); got "
                         f"{frames.shape}")
    fitted = [fit_spectral(frame, m_max=m_max, l_max=l_max, lon=lon,
                           lat=lat, xcyclic=xcyclic, dtype=dtype,
                           device=device) for frame in frames]
    return SpectralBackground(
        coeffs=torch.stack([f.coeffs for f in fitted]),
        lat0=fitted[0].lat0,
    )


def lerp_coeffs(sbg: SpectralBackground, tfrac) -> SpectralBackground:
    """The (T, Mp, L, C) fit blended at the fractional frame index
    ``tfrac`` (rounded to the coefficients' dtype and held to the frame
    range): (1 - w) * coeffs[t0] + w * coeffs[t0 + 1] with t0 = floor(tfrac)
    clipped to [0, T - 2] and w = tfrac - t0, as the JAX package has it.
    Nothing is read back from the card."""
    coeffs = sbg.coeffs
    if coeffs.ndim != 4:
        raise ValueError("lerp_coeffs needs a time-varying fit "
                         "(fit_spectral_time)")
    nt = coeffs.shape[0]
    tf = torch.clamp(torch.as_tensor(tfrac, dtype=torch.float64).to(
        device=coeffs.device, dtype=coeffs.dtype), 0.0, nt - 1.0)
    t0 = _cell_index(tf, nt - 1).reshape(1)
    w = tf - t0[0].to(coeffs.dtype)
    c = ((1.0 - w) * coeffs.index_select(0, t0)[0]
         + w * coeffs.index_select(0, t0 + 1)[0])
    return SpectralBackground(coeffs=c, lat0=sbg.lat0)


def _basis_lon(lon: torch.Tensor, m_max: int) -> torch.Tensor:
    """(R, 2*m_max+1) rows [1, cos(1..M * lon), sin(1..M * lon)]."""
    one = torch.ones_like(lon)[:, None]
    if m_max == 0:
        return one
    marr = torch.arange(1, m_max + 1, dtype=lon.dtype, device=lon.device)
    ang = lon[:, None] * marr[None, :]
    return torch.cat([one, torch.cos(ang), torch.sin(ang)], dim=1)


def _basis_lat(lat: torch.Tensor, lat0, l_max: int) -> torch.Tensor:
    """(R, l_max) rows cos(l * (lat - lat0))."""
    larr = torch.arange(l_max, dtype=lat.dtype, device=lat.device)
    return torch.cos((lat - lat0)[:, None] * larr[None, :])


#: The ``matmul_dtype``s served (every floating dtype that both torch and
#: JAX name), by the case code ``csrc/spectral.cu`` takes for operands
#: rounded to them (0: no rounding).
OPERAND_DTYPES = {torch.bfloat16: 1, torch.float16: 2, torch.float32: 3,
                  torch.float64: 0, torch.float8_e4m3fn: 4,
                  torch.float8_e5m2: 5, torch.float8_e4m3fnuz: 6,
                  torch.float8_e5m2fnuz: 7}

#: The formats rounded to on float64 arithmetic (torch's own casts round
#: float64 to them through float32, twice, and saturate float8_e4m3fn;
#: JAX rounds once, overflowing to inf or NaN): significand bits (with the
#: implicit one), least normal exponent, largest finite value, whether an
#: overflow is inf (else NaN), whether the format has a negative zero.
_FORMATS = {torch.float16: (11, -14, 65504.0, True, True),
            torch.float8_e4m3fn: (4, -6, 448.0, False, True),
            torch.float8_e5m2: (3, -14, 57344.0, True, True),
            torch.float8_e4m3fnuz: (4, -7, 240.0, False, False),
            torch.float8_e5m2fnuz: (3, -15, 57344.0, False, False)}


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k in float64 from its bits, for int64 k in [-1022, 1023]: exact on
    any device (CUDA's pow(2, k) is not)."""
    return ((k + 1023) << 52).view(torch.float64)


def operand_case(dtype: torch.dtype, matmul_dtype) -> int:
    """The kernel's case code for operands in ``matmul_dtype`` over
    ``dtype`` coefficients: 0 for None or a dtype at least as wide as the
    coefficients (no rounding, as in JAX), else ``OPERAND_DTYPES``' code.
    Raises ValueError on a dtype outside ``OPERAND_DTYPES``."""
    if matmul_dtype is None:
        return 0
    if not isinstance(matmul_dtype, torch.dtype) or not (
            matmul_dtype.is_floating_point and not matmul_dtype.is_complex):
        raise ValueError(f"matmul_dtype must be a floating torch dtype, "
                         f"got {matmul_dtype!r}")
    if matmul_dtype not in OPERAND_DTYPES:
        raise ValueError(
            f"matmul_dtype={matmul_dtype} is not served; the served operand "
            f"dtypes are {', '.join(map(str, OPERAND_DTYPES))}")
    if matmul_dtype.itemsize >= dtype.itemsize:
        return 0
    return OPERAND_DTYPES[matmul_dtype]


def round_operands(x: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """``x`` rounded to ``matmul_dtype`` and held in ``x``'s dtype, as the
    JAX package's ``astype`` rounds it: to float16 and every float8 once,
    to nearest even at the format's precision, with its subnormals and its
    overflow (inf for float16 and float8_e5m2, NaN for the others), in
    float64 arithmetic, then cast back (exactly); to bfloat16 and float32
    by torch's cast (float64 to bfloat16 through float32, as JAX does). A
    dtype at least as wide as ``x``'s, or None, leaves ``x`` as it is."""
    if operand_case(x.dtype, matmul_dtype) == 0:
        return x
    if matmul_dtype not in _FORMATS:
        return x.to(matmul_dtype).to(x.dtype)
    p, emin, big, inf, neg_zero = _FORMATS[matmul_dtype]
    v = x.to(torch.float64)
    _, e = torch.frexp(v)                 # |v| in [2^(e-1), 2^e)
    # q in [-24, 1021] for finite v; the clamp keeps inf's and NaN's
    # exponent (unspecified) in _pow2's range.
    q = (torch.clamp(e.long() - 1, min=emin) - (p - 1)).clamp(-1021, 1021)
    r = torch.round(v * _pow2(-q)) * _pow2(q)
    over = torch.full_like(r, float("nan"))
    if inf:
        over = torch.copysign(torch.full_like(r, float("inf")), v)
    r = torch.where(torch.abs(r) > big, over, r)
    if not neg_zero:
        r = torch.where(r == 0, torch.zeros_like(r), r)
    return r.to(x.dtype)


def sample_spectral(sbg: SpectralBackground, lon, lat, *,
                    matmul_dtype=None) -> torch.Tensor:
    """Evaluate the spectral background at (lon, lat); returns (R, C).

    Rows with |lat| > pi/2 are NaN; NaN positions propagate through the
    basis. ``matmul_dtype`` (one of ``OPERAND_DTYPES``) rounds both product
    operands to that dtype (``round_operands``) and accumulates in the
    coefficient dtype.
    """
    coeffs = sbg.coeffs
    mp, l_max, c = coeffs.shape
    acc_dtype = coeffs.dtype
    lon = torch.as_tensor(lon).to(device=coeffs.device, dtype=acc_dtype)
    lat = torch.as_tensor(lat).to(device=coeffs.device, dtype=acc_dtype)
    blon = _basis_lon(lon, (mp - 1) // 2)
    blat = _basis_lat(lat, sbg.lat0, l_max)
    dflat = coeffs.reshape(mp, l_max * c)
    # Every operand dtype narrower than acc_dtype has at most half its
    # significand bits, so the products of the rounded operands are exact
    # in acc_dtype: multiplying them there IS accumulation in acc_dtype.
    blon = round_operands(blon, matmul_dtype)
    dflat = round_operands(dflat, matmul_dtype)
    w = blon @ dflat
    out = torch.einsum("rl,rlc->rc", blat, w.reshape(-1, l_max, c))
    in_range = torch.abs(lat) <= 0.5 * pi
    return torch.where(in_range[:, None], out,
                       torch.full_like(out, float("nan")))


def sample_mercator_spectral(sbg: SpectralBackground, lon,
                             lat) -> torch.Tensor:
    """Spectral sample + Mercator transform; returns (C, R)."""
    lat = torch.as_tensor(lat).to(device=sbg.coeffs.device,
                                  dtype=sbg.coeffs.dtype)
    return mercator_transform(sample_spectral(sbg, lon, lat), lat)


#: One coefficient tile of ``csrc/spectral.cu``: its k depth (kKC) and its
#: latitude columns (kGroupCols).
KC = 32
GROUP = 80


def packed_dims(mp: int, l_max: int) -> tuple[int, int]:
    """(Kp, Lp): Mp rounded up to ``KC``, L rounded up to 8 (the MMA n
    width)."""
    return -(-mp // KC) * KC, -(-l_max // 8) * 8


def tile_row(dtype: torch.dtype) -> int:
    """Elements in a tile row of operand ``dtype``: ``KC`` plus the
    kernel's pad (kPad), which makes its shared-memory fragment loads free
    of bank conflicts: 8 for 16-bit operands, 4 for 32- and 64-bit ones."""
    return KC + (8 if dtype.itemsize == 2 else 4)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: the result is a float32 whose low 13 bits
    are zero. For finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _operand_type(dtype: torch.dtype, case: int) -> tuple:
    """The kernel's shared-memory operand dtype and B planes for ``case``
    over ``dtype`` coefficients, which name its tensor-core format (the
    kernel's Mode): two TF32 planes (held as float32) with no rounding
    (3xTF32), one float16 plane for float16 operands (the f16 MMA), one
    bfloat16 plane for bf16 and every float8 (the bf16 MMA: every float8
    value is exact in bfloat16); over float64 coefficients one float64
    plane, the operands rounded and held in float64 (DMMA)."""
    if dtype == torch.float64:
        return dtype, 1
    if case == 0:
        return torch.float32, 2
    if case == OPERAND_DTYPES[torch.float16]:
        return torch.float16, 1
    return torch.bfloat16, 1


def pack_coeffs(coeffs: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """Repack (Mp, L, C) coefficients into the kernel's tiles:
    (C, G, Kp / KC, P, GROUP, tile_row), G = ceil(L / GROUP) column groups.

    Tile (c, g, k) holds coeffs[k * KC + kk, g * GROUP + n, c] at [.., p, n,
    kk], as the kernel's shared memory holds it, so one bulk copy stages it;
    zero past Mp, past L and in the row pad. The values are rounded to
    ``matmul_dtype`` (``round_operands``) and held as ``_operand_type``
    says: float32 with no rounding in P = 2 planes, the 3xTF32 split hi =
    tf32(x), lo = tf32(x - hi); else P = 1. The plain version of
    ``pack_on_card``.
    """
    mp, l_max, c = coeffs.shape
    kp, _ = packed_dims(mp, l_max)
    g = -(-l_max // GROUP)
    op, n_planes = _operand_type(coeffs.dtype,
                                 operand_case(coeffs.dtype, matmul_dtype))
    b = torch.nn.functional.pad(
        round_operands(coeffs, matmul_dtype).permute(2, 1, 0),
        (0, kp - mp, 0, g * GROUP - l_max))
    if n_planes == 2:
        hi = tf32_round(b)
        planes = torch.stack([hi, tf32_round(b - hi)], dim=1)
    else:
        planes = b.to(op)[:, None]
    tiles = planes.reshape(c, -1, g, GROUP, kp // KC, KC)
    tiles = tiles.permute(0, 2, 4, 1, 3, 5)
    return torch.nn.functional.pad(
        tiles, (0, tile_row(tiles.dtype) - KC)).contiguous()


def pack_on_card(coeffs: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """``pack_coeffs`` on CUDA coefficients in one launch of the packing
    kernel (``rwrt_spectral_pack``: the kernel's own rounding, bitwise
    ``round_operands``'), counted in ``PACK_LAUNCHES``; on CPU
    coefficients ``pack_coeffs``."""
    case = operand_case(coeffs.dtype, matmul_dtype)
    if not coeffs.is_cuda:
        return pack_coeffs(coeffs, matmul_dtype)
    global PACK_LAUNCHES
    op, n_planes = _operand_type(coeffs.dtype, case)
    mp, l_max, c = coeffs.shape
    kp, _ = packed_dims(mp, l_max)
    coeffs = coeffs.contiguous()
    out = torch.empty((c, -(-l_max // GROUP), kp // KC, n_planes, GROUP,
                       tile_row(op)), dtype=op, device=coeffs.device)
    kernels.launch("rwrt_spectral_pack", coeffs.dtype, coeffs, mp, l_max, c,
                   case, out, kernels.stream(coeffs.device))
    PACK_LAUNCHES += 1
    return out


def sample_spectral_cuda(sbg: SpectralBackground, lon, lat, *,
                         matmul_dtype=None) -> torch.Tensor:
    """Kernel-backed evaluation (counterpart of ``sample_spectral_pallas``).

    On CUDA tensors it launches ``csrc/spectral.cu``; on CPU tensors it runs
    ``sample_spectral``. The result equals ``sample_spectral`` with the same
    ``matmul_dtype`` up to the order of the contraction's sums. Every dtype
    of ``OPERAND_DTYPES`` is served, on either device; any other raises
    ValueError.
    """
    coeffs = sbg.coeffs
    operand_case(coeffs.dtype, matmul_dtype)
    if not coeffs.is_cuda:
        return sample_spectral(sbg, lon, lat, matmul_dtype=matmul_dtype)
    global LAUNCHES
    dtype, dev = coeffs.dtype, coeffs.device
    lon = torch.as_tensor(lon).to(device=dev, dtype=dtype).contiguous()
    lat = torch.as_tensor(lat).to(device=dev, dtype=dtype).contiguous()
    if lon.ndim != 1 or lon.shape != lat.shape:
        raise ValueError("lon and lat must be matching (R,) vectors")
    tht = (lat - sbg.lat0.to(device=dev, dtype=dtype)).contiguous()
    out = torch.empty((lon.shape[0], coeffs.shape[2]), dtype=dtype,
                      device=dev)
    if lon.shape[0] == 0:
        return out
    launch_kernel(pack_on_card(coeffs, matmul_dtype), lon, lat, tht,
                  coeffs.shape, matmul_dtype, out)
    LAUNCHES += 1
    return out


def launch_kernel(packed, lon, lat, tht, coeffs_shape, matmul_dtype,
                  out) -> None:
    """Launch ``csrc/spectral.cu`` on prepared operands: ``packed`` from
    ``pack_on_card`` (or ``pack_coeffs``) with the same ``matmul_dtype``,
    contiguous (R,) lon, lat and tht = lat - lat0, and the (R, C) output,
    all on one card in the coefficient dtype. Checks them and raises on what the kernel does not
    take; counts nothing (the wrapper does)."""
    mp, l_max, c = coeffs_shape
    if mp % 2 != 1:
        raise ValueError(f"coefficients need Mp = 2 * m_max + 1 rows, got {mp}")
    dtype, dev, r = lon.dtype, lon.device, lon.shape[0]
    case = operand_case(dtype, matmul_dtype)
    kp, lp = packed_dims(mp, l_max)
    for name, x in (("lon", lon), ("lat", lat), ("tht", tht)):
        kernels.check_tensor(x, name, device=dev, dtype=dtype, shape=(r,))
    kernels.check_tensor(out, "out", device=dev, dtype=dtype, shape=(r, c))
    op, n_planes = _operand_type(dtype, case)
    kernels.check_tensor(
        packed, "packed coeffs", device=dev, dtype=op,
        shape=(c, -(-l_max // GROUP), kp // KC, n_planes, GROUP,
               tile_row(op)))
    kernels.launch("rwrt_spectral", dtype, lon, lat, tht, packed, r, mp,
                   l_max, c, kp, lp, case, out, kernels.stream(dev))


def round_on_card(x: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """``x`` (float32 or float64) through the kernel's own operand rounding
    to ``matmul_dtype`` (``rwrt_spectral_round``, the device function its
    prologue rounds the basis with), held in ``x``'s dtype: the check that
    it rounds as ``round_operands`` does, which a CPU tensor takes. Not on
    any run path; counts nothing."""
    operand_case(x.dtype, matmul_dtype)              # raises on a bad one
    if not x.is_cuda:
        return round_operands(x, matmul_dtype)
    case = 0 if matmul_dtype is None else OPERAND_DTYPES[matmul_dtype]
    x = x.contiguous()
    out = torch.empty_like(x)
    kernels.launch("rwrt_spectral_round", x.dtype, x, x.numel(), case, out,
                   kernels.stream(x.device))
    return out
