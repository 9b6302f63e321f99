"""
Cosine-fit sub-sample lag interpolation (Céspedes et al. 1995), batched
over rows.

Namesake of detex_tpu/ops/subsample.py (reference construct.py:397-422,
_subSamp).
"""
from __future__ import annotations

import torch


def subsample_shift(ceval, ind):
    """Sub-sample shift of the peak at integer index ``ind[r]`` of each
    correlation row ``ceval[r]`` (ceval [R, L] float tensor, ind [R] int):
    tau [R] in (-0.5, 0.5).

    Where the reference warns and returns the integer index for |tau| > .5
    (a bug, construct.py:418-421) this returns 0.0, as detex_tpu does; an
    arccos argument outside [-1, 1] (a flat or degenerate peak) and a peak
    on the row's first or last sample also give 0.0."""
    L = ceval.shape[-1]
    ind = ind.to(torch.int64)
    interior = (ind > 0) & (ind < L - 1)
    i = ind.clamp(1, L - 2)[:, None]
    cb4 = ceval.gather(1, i - 1)[:, 0]
    caf = ceval.gather(1, i + 1)[:, 0]
    cn = ceval.gather(1, i)[:, 0]
    arg = (cb4 + caf) / (2.0 * cn)
    ok = interior & (arg.abs() < 1.0) & (cn != 0.0)
    alpha = torch.arccos(arg.clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    denom = 2.0 * cn * torch.sin(alpha)
    one = torch.ones_like(cn)
    tau = -(torch.arctan((cb4 - caf) / torch.where(denom == 0, one, denom))
            / torch.where(alpha == 0, one, alpha))
    return torch.where(ok & (tau.abs() <= 0.5), tau, torch.zeros_like(tau))
