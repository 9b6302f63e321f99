"""
Detection-theory statistics: the doubly noncentral beta machinery behind
selectCriteria 1, the choice of a subspace's dimension of representation
that maximizes the probability of detection at the configured false-alarm
rate (Harris 2006 §9; the reference reserved the option but never
implemented it, subspace.py:802-807).

Namesake of detex_tpu/stats.py, host float64 numpy and scipy. Under white
Gaussian noise the detection statistic

    DS = ||U_d^T x||^2 / ||x||^2

of a d-dimensional subspace over an N-sample window is the ratio
X1 / (X1 + X2) with X1 ~ chi^2_d(lambda1) carrying the captured signal
energy and X2 ~ chi^2_{N-d}(lambda2) the missed energy. Its survival
function is an exact double Poisson mixture of central beta survival
functions, which ``dnc_beta_sf`` evaluates (truncated far past the Poisson
mass).
"""
from __future__ import annotations

import numpy as np
import scipy.stats


def _poisson_terms(lam, tail=1e-12):
    """Indices and weights of a Poisson(lam/2) mixture covering all but
    ``tail`` of the mass."""
    mean = lam / 2.0
    if mean <= 0:
        return np.array([0]), np.array([1.0])
    half = 10.0 * np.sqrt(mean + 1.0)
    lo = max(0, int(np.floor(mean - half)))
    hi = int(np.ceil(mean + half)) + 1
    k = np.arange(lo, hi)
    w = scipy.stats.poisson.pmf(k, mean)
    keep = w > tail
    return k[keep], w[keep]


def dnc_beta_sf(gamma, d, nu2, lam1, lam2):
    """
    P(X > gamma) for the doubly noncentral beta
    X = chi2_d(lam1) / (chi2_d(lam1) + chi2_nu2(lam2)) — equivalently the
    doubly noncentral F_{d, nu2}(lam1, lam2) survival function evaluated at
    the matching quantile. Exact double Poisson-mixture evaluation.
    """
    i, wi = _poisson_terms(lam1)
    j, wj = _poisson_terms(lam2)
    a = d / 2.0 + i[:, None]
    b = nu2 / 2.0 + j[None, :]
    sf = scipy.stats.beta.sf(gamma, a, b)
    return float(wi @ sf @ wj)


def null_threshold(Pf, d, N):
    """White-noise null threshold: DS ~ Beta(d/2, (N-d)/2) under H0, so
    gamma = isf(Pf)."""
    return float(scipy.stats.beta.isf(Pf, d / 2.0, (N - d) / 2.0))


def dim_of_max_pd(frac_energy_avg, N, Pf, snr):
    """
    Harris 2006 optimal dimension of representation: for each candidate
    dimension d, set the threshold from the white-noise null at the
    configured Pf and evaluate the probability of detecting a signal with
    total energy-to-noise ratio ``snr`` whose fraction ``frac_energy_avg[d]``
    is captured by the first d basis vectors (the rest inflates the
    denominator). Returns (best_d, [P_D per d starting at d=1]).

    Parameters
    ----------
    frac_energy_avg : cumulative average fractional energy capture,
        frac_energy_avg[d] = fraction captured by d dimensions
        (element 0 is 0; the reference's FracEnergy['Average']).
    N : window length in multiplexed samples (statistic DOF).
    Pf : design false-alarm probability.
    snr : design total signal-energy-to-noise-variance ratio
        (sum s_i^2 / sigma^2).
    """
    frac = np.asarray(frac_energy_avg, dtype=float)
    kmax = len(frac) - 1
    if kmax < 1:
        return 1, np.array([1.0])
    pds = np.zeros(kmax)
    for d in range(1, kmax + 1):
        f = min(max(frac[d], 0.0), 1.0)
        gamma = null_threshold(Pf, d, N)
        pds[d - 1] = dnc_beta_sf(gamma, d, N - d, snr * f,
                                 snr * (1.0 - f))
    return int(np.argmax(pds)) + 1, pds
