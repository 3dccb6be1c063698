"""FID statistics and the Frechet distance, numpy only (a copy of
``im23d_tpu/metrics/fid.py`` without its JAX forward helper).

The trace of the matrix square root is taken from two symmetric
eigendecompositions instead of a full ``scipy.linalg.sqrtm``.
"""

from __future__ import annotations

import warnings

import numpy as np


def calculate_stats(act: np.ndarray):
    """Activation matrix (N, D) -> (mean (D,), covariance (D, D))."""
    mu = np.mean(act, axis=0)
    sigma = np.cov(act, rowvar=False)
    return mu, sigma


def trace_sqrt_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """Tr(sqrt(sigma1 @ sigma2)) for PSD covariances:
    Tr(sqrt(C1^1/2 C2 C1^1/2)) = sum sqrt(eig(inner)), inner symmetric PSD;
    negative eigenvalue noise is clipped."""
    sym1 = (sigma1 + sigma1.T) / 2.0
    w1, v1 = np.linalg.eigh(sym1)
    sq1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    inner = sq1 @ ((sigma2 + sigma2.T) / 2.0) @ sq1
    w = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    return float(np.sum(np.sqrt(np.clip(w, 0.0, None))))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d² = ||mu1 − mu2||² + Tr(C1 + C2 − 2 sqrt(C1 C2)); NaN, with a
    warning, for non-finite inputs.  ``eps`` is accepted for the reference's
    signature and unused: the eigenvalue clip needs no diagonal retry."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics of shapes {mu1.shape}, {sigma1.shape} "
                         f"and {mu2.shape}, {sigma2.shape} do not pair up")
    if not (np.isfinite(sigma1).all() and np.isfinite(sigma2).all()
            and np.isfinite(mu1).all() and np.isfinite(mu2).all()):
        warnings.warn("fid inputs contain non-finite values; returning NaN")
        return float("nan")
    del eps
    diff = mu1 - mu2
    tr_covmean = trace_sqrt_product(sigma1, sigma2)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * tr_covmean)
