"""Port parity: the gather probe (``rwrt_tpu_torch/probes/gather_probe.py``)
against the JAX probe (``benchmarks/pallas_gather_probe.py``).

The probe's Pallas kernel is rebuilt here as the JAX probe writes it (the
probe keeps it inside ``main``) and run in interpret mode on the CPU. A
gather is a copy, so the port's plain gather is held to it, and to XLA's
gather, bitwise. The chain sums each gathered row, and XLA and PyTorch sum
48 floats in different orders: held to 1e-6 of each value in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rwrt_tpu_torch.probes import gather_probe as gp

#: The probe's block of rows per grid step; two grid steps here.
BLOCK = 2048
R_SMALL = 2 * BLOCK


def pallas_gather(t, i, width, r):
    """The JAX probe's ``pallas_gather`` (and body ``gather_kernel``),
    in interpret mode."""

    def gather_kernel(idx_ref, table_ref, out_ref):
        def body(k, _):
            out_ref[k, :] = table_ref[idx_ref[k], :]
            return 0

        jax.lax.fori_loop(0, BLOCK, body, 0)

    return pl.pallas_call(
        gather_kernel,
        grid=(r // BLOCK,),
        in_specs=[
            pl.BlockSpec((BLOCK,), lambda g: (g,), memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((BLOCK, width), lambda g: (g, 0)),
        out_shape=jax.ShapeDtypeStruct((r, width), jnp.float32),
        interpret=True,
    )(i, t)


@pytest.fixture(scope="module")
def data():
    """The probe's own inputs (seed 0), on the CPU."""
    idx0, tables = gp.inputs("cpu")
    return idx0, {w: t for w, t in tables.items()}


def test_plain_gather_equals_pallas_kernel(data):
    idx0, tables = data
    idx = idx0[:R_SMALL]
    want = pallas_gather(jnp.asarray(tables[48].numpy()),
                         jnp.asarray(idx.numpy()), 48, R_SMALL)
    got = gp.gather_rows_plain(tables[48], idx)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("width", gp.WIDTHS)
def test_plain_gather_equals_xla_gather(data, width):
    idx0, tables = data
    t = tables[width]
    want = jnp.asarray(t.numpy()).at[jnp.asarray(idx0.numpy())].get(
        mode="promise_in_bounds")
    got = gp.gather_rows_plain(t, idx0)
    assert got.shape == (gp.R, width)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_chain_matches_jax(data):
    """Three links of the probe's chain, both ways (1e-6 relative: the row
    sums' order differs)."""
    idx0, tables = data
    n = 3
    t, i0 = jnp.asarray(tables[48].numpy()), jnp.asarray(idx0.numpy())

    def it(i, acc):
        v = t.at[(i0 + i) % (gp.WH - 2)].get(mode="promise_in_bounds")
        return acc + jnp.sum(v, axis=-1)

    want = np.asarray(jax.lax.fori_loop(0, n, it,
                                        jnp.zeros(gp.R, jnp.float32)))
    got = gp.chain(gp.gather_rows, tables[48], idx0, n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_gather_rows_on_the_cpu_takes_the_plain_version(data):
    idx0, tables = data
    before = gp.LAUNCHES
    for w in gp.WIDTHS:
        assert torch.equal(gp.gather_rows(tables[w], idx0),
                           gp.gather_rows_plain(tables[w], idx0))
        assert torch.equal(gp.gather_index(tables[w], idx0),
                           gp.gather_rows_plain(tables[w], idx0))
    assert gp.LAUNCHES == before


def test_probe_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        gp.probe("cpu")
