"""Probe: a hand-written row gather against PyTorch's for the background
sample's access pattern.

Port of ``benchmarks/pallas_gather_probe.py``. The background sample of the
ray RHS gathers one row of the corner-packed (nlon_wrap * nlat, 48) table per
ray; the probe measures that access alone: a (145 * 73, width) float32
table read by 131,072 int32 row indices, chained 30 times,
``acc += sum(gather(table, (idx + i) % (WH - 2)), -1)``, at widths 48, 128
and 384, and prints ms per gather and ns per row for each gather:

- ``gather_rows``: the wrapper of the hand-written kernel
  (``csrc/gather.cu``, the counterpart of the JAX probe's Pallas
  ``pallas_gather``, which ran at width 48 only), on a CUDA table; on a CPU
  table the plain version;
- ``table[idx]`` and ``table.index_select(0, idx)`` (the plain version,
  ``gather_rows_plain``), PyTorch's own gathers, where the JAX probe timed
  XLA's.

Run on the card:

    python -m rwrt_tpu_torch.probes.gather_probe

``LAUNCHES`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import numpy as np
import torch

from rwrt_tpu_torch import kernels

#: The probe's shapes (the JAX probe's): the packed 144 x 73 background's
#: rows with its wrap column, the indices, the chain's length, the widths.
WH = 145 * 73
R = 131072
N = 30
WIDTHS = (48, 128, 384)

#: Number of gather kernel launches in this process.
LAUNCHES = 0


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = table[idx[i], :]: ``Tensor.index_select``."""
    return table.index_select(0, idx.long())


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = table[idx[i], :] for a (rows, width) table and (R,) int32
    indices in [0, rows): one launch of ``csrc/gather.cu`` on a CUDA table,
    the plain version on a CPU one."""
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    return _gather_cuda(table, idx)


def _gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the gather kernel: one thread per 16-byte vector of the
    output. Raises unless the table is a contiguous float32 or float64
    (rows, width) tensor whose rows are whole 16-byte vectors, starting on
    a 16-byte boundary, and idx a contiguous (R,) int32 tensor on the same
    card. The indices are not checked (an out-of-range one reads outside
    the table)."""
    global LAUNCHES
    if table.ndim != 2 or table.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"table must be a 2-D float32 or float64 tensor; "
                         f"got {tuple(table.shape)} {table.dtype}")
    kernels.check_tensor(table, "table", device=table.device,
                         dtype=table.dtype)
    kernels.check_aligned(table, "table")
    r = idx.shape[0] if idx.ndim == 1 else -1
    kernels.check_tensor(idx, "idx", device=table.device, dtype=torch.int32,
                         shape=(r,))
    width = table.shape[1]
    row_bytes = width * table.element_size()
    if row_bytes % 16:
        raise ValueError(f"a row of {row_bytes} bytes is not a whole number "
                         "of 16-byte vectors")
    if r * (row_bytes // 16) >= 2**31:
        raise ValueError(f"{r} rows of {row_bytes} bytes exceed the "
                         "kernel's 32-bit vector count")
    out = torch.empty((r, width), dtype=table.dtype, device=table.device)
    kernels.launch("rwrt_gather", table.dtype, table, width, idx, r, out,
                   kernels.stream(table.device))
    LAUNCHES += 1
    return out


def gather_index(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: PyTorch's advanced indexing."""
    return table[idx]


#: The gathers the probe times, by the name it prints.
GATHERS = {"gather_rows (kernel)": gather_rows,
           "table[idx]": gather_index,
           "index_select (plain)": gather_rows_plain}


def inputs(device, seed: int = 0):
    """The probe's data, made as the JAX probe makes it: (idx0 (R,) int32,
    {width: (WH, width) float32 table}) from ``default_rng(seed)``, the
    indices first, then the tables in ``WIDTHS``' order."""
    rng = np.random.default_rng(seed)
    idx0 = torch.as_tensor(rng.integers(0, WH - 2, R).astype(np.int32),
                           device=device)
    tables = {w: torch.as_tensor(
        rng.normal(size=(WH, w)).astype(np.float32), device=device)
        for w in WIDTHS}
    return idx0, tables


def chain(gather, table: torch.Tensor, idx0: torch.Tensor,
          n: int | None = None) -> torch.Tensor:
    """``acc += sum(gather(table, (idx0 + i) % (WH - 2)), -1)`` for i in
    0..n-1 (default ``N``), from acc = 0: (R,) in the table's dtype."""
    acc = torch.zeros(idx0.shape[0], dtype=table.dtype, device=table.device)
    for i in range(N if n is None else n):
        acc = acc + gather(table, torch.remainder(idx0 + i, WH - 2)).sum(-1)
    return acc


def time_chain(gather, table, idx0, reps: int = 5) -> float:
    """Device time of one gather of the chain in ms: the median over
    ``reps`` runs of the whole ``N``-long chain (CUDA events, one warm-up
    run first) over N."""
    chain(gather, table, idx0)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(gather, table, idx0)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / N)
    return float(np.median(times))


def probe(device="cuda", seed: int = 0) -> dict:
    """Time every gather of ``GATHERS`` in the chain at every width of
    ``WIDTHS`` on ``device`` (a card) and print a line each; returns
    {(name, width): ms per gather}."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the probe times the card: pass a CUDA device")
    idx0, tables = inputs(device, seed)
    out = {}
    for width in WIDTHS:
        for name, gather in GATHERS.items():
            ms = time_chain(gather, tables[width], idx0)
            out[(name, width)] = ms
            print(f"{name:<22s} width={width:4d}: {ms:7.3f} ms "
                  f"= {ms * 1e6 / R:6.2f} ns/row")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: no CUDA device; the probe times "
                         "the card")
    print(torch.cuda.get_device_name(0))
    probe()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
