"""Group velocity (ug, vg) from the dispersion relation.

Port of ``rwrt_tpu/ops/groupvel.py``:

    ug = fu + [(1 - kap^2) fqy - 2 kap fqx] / (K^2 (1 + kap^2))
    vg = fv + [2 kap fqy + (1 - kap^2) fqx] / (K^2 (1 + kap^2))

with kap = m/k and K^2 = k^2 (1 + kap^2). NaN inputs give NaN outputs in
both dialects; ``zero_invalid`` only adds the zwn == 0 -> 0 shortcut.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _zero_nan(x, fill):
    n = torch.isnan(x)
    return n, torch.where(n, torch.full_like(x, fill), x)


def group_velocity_core(fu, fv, fqx, fqy, zwn, mwn):
    """Sanitized compute + NaN masks.

    Evaluates the formula on NaN-free substitutes and returns the masks of
    where the IEEE result would be NaN: ug is NaN iff any of (fu, fqx, fqy,
    zwn, mwn) is NaN or zwn == 0 (0 * inf in the denominator), vg likewise
    with fv. Returns (ug, vg, ug_nan, vg_nan); entries under the masks are
    finite garbage, so a zero cotangent there stays zero in reverse mode.
    """
    n_u, fu_s = _zero_nan(fu, 0.0)
    n_v, fv_s = _zero_nan(fv, 0.0)
    n_x, fqx_s = _zero_nan(fqx, 0.0)
    n_y, fqy_s = _zero_nan(fqy, 0.0)
    n_k = torch.isnan(zwn) | (zwn == 0.0)
    zwn_s = torch.where(n_k, torch.ones_like(zwn), zwn)
    n_m, mwn_s = _zero_nan(mwn, 0.0)

    kap = mwn_s / zwn_s
    kap2 = kap * kap
    kap1 = 1.0 + kap2
    denom = zwn_s * zwn_s * kap1 * kap1
    ug = fu_s + ((1.0 - kap2) * fqy_s - 2.0 * kap * fqx_s) / denom
    vg = fv_s + (2.0 * kap * fqy_s + (1.0 - kap2) * fqx_s) / denom
    shared = n_x | n_y | n_k | n_m
    return ug, vg, n_u | shared, n_v | shared


def group_velocity(
    fu, fv, fqx, fqy, zwn, mwn, *, zero_invalid: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute (ug, vg); all args broadcastable tensors, any shape."""
    fu, fv, fqx, fqy, zwn, mwn = torch.broadcast_tensors(
        fu, fv, fqx, fqy, zwn, mwn)
    ug, vg, ug_nan, vg_nan = group_velocity_core(fu, fv, fqx, fqy, zwn, mwn)
    nan = torch.full_like(ug, float("nan"))
    ug = torch.where(ug_nan, nan, ug)
    vg = torch.where(vg_nan, nan, vg)
    if zero_invalid:
        zero = torch.zeros_like(ug)
        ug = torch.where(zwn == 0.0, zero, ug)
        vg = torch.where(zwn == 0.0, zero, vg)
    return ug, vg
