"""What surrounds the RK4 and exact kernels' evaluation on the CPU: the
arithmetic of ``csrc/ray_rhs.cuh``'s floor_mod shortcut and the launcher's
choice of instance (``kernels.choose_instance``). The kernels themselves are held to their
plain versions on the card (tests/test_torch_cuda_kernels.py)."""

import math

import numpy as np
import pytest
import torch

from rwrt_tpu_torch import kernels

DTYPES = [torch.float32, torch.float64]


def floor_mod_fmod(x, m):
    """ray_rhs.cuh floor_mod before the shortcut: fmod, then the divisor's
    sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def floor_mod_shortcut(x, m):
    """ray_rhs.cuh floor_mod: x itself inside (-m, m), fmod elsewhere."""
    r = torch.where((x > -m) & (x < m), x, torch.fmod(x, m))
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_floor_mod_shortcut_keeps_every_bit(dtype):
    """On 0, -0, +-m, the neighbours of +-m, +-4 pi, NaN, +-inf and a spread
    of ordinary values: the shortcut equals the fmod form bit for bit (the
    sign of zero included) and torch.remainder, which the plain version
    calls, by value."""
    m = torch.tensor(2 * math.pi, dtype=torch.float64).to(dtype)
    inf = torch.tensor(math.inf, dtype=dtype)
    edges = [m, -m, torch.nextafter(m, inf), torch.nextafter(m, -inf),
             torch.nextafter(-m, inf), torch.nextafter(-m, -inf)]
    special = torch.tensor([0.0, -0.0, 4 * math.pi, -4 * math.pi, math.nan,
                            math.inf, -math.inf], dtype=dtype)
    rng = np.random.default_rng(5)
    spread = torch.as_tensor(rng.uniform(-20.0, 20.0, 4000), dtype=dtype)
    x = torch.cat([torch.stack(edges), special, spread])
    short, ref = floor_mod_shortcut(x, m), floor_mod_fmod(x, m)
    assert torch.equal(bits(short), bits(ref))
    rem = torch.remainder(x, m)
    assert torch.equal(short.isnan(), rem.isnan())
    assert torch.equal(torch.nan_to_num(short), torch.nan_to_num(rem))
    # x = -m is left to fmod, whose -0 the shortcut would turn into +0.
    assert math.copysign(1.0, float(short[1])) == -1.0


#: Threads of a team instance the card keeps resident, for the rule's
#: test: the H100's 132 SMs x blocks of 128 threads at the blocks an SM
#: holds with each kernel's registers (RK4 ~80 a thread in float32, ~150
#: in float64; exact ~120 and ~216).
RESIDENT = {("rk4", torch.float32): 101_376, ("rk4", torch.float64): 50_688,
            ("exact", torch.float32): 67_584,
            ("exact", torch.float64): 33_792}


@pytest.mark.parametrize("kernel", ["rk4", "exact"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_choose_instance_rule(dtype, kernel):
    """For R from 1 to 10^6, with the measured window: the team
    ``kernels.TEAM`` exactly from the window's least lane count to its most
    or to the resident count over 8, whichever is smaller, one thread per
    lane elsewhere; so one window of R, never a lone lane, never a second
    wave."""
    lanes = kernels.TEAM_LANES
    res = RESIDENT[kernel, dtype]
    top = min(lanes[1], res // 8)
    rs = np.unique(np.concatenate([
        np.geomspace(1, 10**6, 400).astype(int), [1, 10**6],
        [lanes[0] + d for d in (-1, 0, 1)], [top + d for d in (-1, 0, 1)]]))
    got = [kernels.choose_instance(int(r), res) for r in rs]
    want = [kernels.TEAM if lanes[0] <= r <= top else "lane" for r in rs]
    assert got == want
    assert got[0] == got[-1] == "lane" and kernels.TEAM in got
    flips = sum(a != b for a, b in zip(got, got[1:]))
    assert flips == 2
    assert all(8 * r <= res for r, g in zip(rs, got) if g != "lane")


def test_instance_ids_match_the_kernels():
    """The ids the C entry points take (ray_rhs.cuh kId), the launcher's
    team among them, and an unknown instance refused."""
    assert kernels.INSTANCES == {"lane": 0, "split8": 8}
    assert kernels.instance_id("split8") == 8
    assert kernels.TEAM in kernels.INSTANCES and kernels.TEAM != "lane"
    with pytest.raises(ValueError):
        kernels.instance_id("team16")
