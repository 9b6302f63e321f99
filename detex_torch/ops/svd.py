"""
SVD of aligned event waveforms and their fractional energy capture
(reference subspace.py:786-1013).

Namesake of detex_tpu/ops/svd.py. dtype "double" runs on the host in
float64 numpy, the reference's scipy.linalg.svd numerics (subspace.py:890);
dtype "single" runs ``torch.linalg.svd`` and the projection in float32 on
``device`` (the card unless "cpu"), with TF32 off for the projection's
matrix product. Singular vectors are determined up to sign; the detection
statistic does not depend on it.
"""
from __future__ import annotations

import numpy as np
import torch


def _no_tf32(fn):
    """Run fn() with TF32 matrix products off, restoring the setting."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def svd_basis(aligned, normalize=False, dtype="double", device="cuda"):
    """Left singular vectors and singular values of aligned, demeaned
    waveforms ``aligned`` [N_events, n] (rows demeaned by the caller,
    reference _trimGroups subspace.py:921-943); ``normalize`` scales each
    row to unit energy first. Returns (U [n, k], s [k]) float64 numpy with
    k = min(N, n), singular values descending: scipy.linalg.svd(tparr,
    full_matrices=False) at subspace.py:890."""
    if dtype == "double":
        arr = np.asarray(aligned, np.float64)
        if normalize:
            arr = arr / np.linalg.norm(arr, axis=1, keepdims=True)
        U, s, _ = np.linalg.svd(arr.T, full_matrices=False)
        return U, s
    arr = torch.as_tensor(np.asarray(aligned), dtype=torch.float32,
                          device=device)
    if normalize:
        arr = arr / torch.linalg.norm(arr, dim=1, keepdim=True)
    U, s, _ = torch.linalg.svd(arr.T, full_matrices=False)
    return (U.cpu().numpy().astype(np.float64),
            s.cpu().numpy().astype(np.float64))


def frac_energy(U, aligned, dtype="double", device="cuda"):
    """Cumulative fractional energy captured per dimension of
    representation by each training waveform (reference _getFracEnergy,
    subspace.py:968-997): U [n, k] left singular vectors, ``aligned``
    [N, n] the aligned, trimmed waveforms (not demeaned: the reference
    passes the raw aligned waveform). Returns cum [N, k+1] float64 numpy
    with a leading 0 for dimension 0."""
    if dtype == "double":
        U = np.asarray(U, np.float64)
        A = np.asarray(aligned, np.float64)
        rep = (A @ U / np.linalg.norm(A, axis=1, keepdims=True)) ** 2
        return np.concatenate([np.zeros((A.shape[0], 1)),
                               np.cumsum(rep, axis=1)], axis=1)
    Ut = torch.as_tensor(np.asarray(U), dtype=torch.float32, device=device)
    A = torch.as_tensor(np.asarray(aligned), dtype=torch.float32,
                        device=device)
    proj = _no_tf32(lambda: A @ Ut)                       # [N, k]
    rep = (proj / torch.linalg.norm(A, dim=1, keepdim=True)) ** 2
    cum = torch.cat([torch.zeros_like(rep[:, :1]), rep.cumsum(dim=1)], dim=1)
    return cum.cpu().numpy().astype(np.float64)
