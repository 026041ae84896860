"""KID and the Inception Score (``psld_tpu/eval/fid/metrics.py``), the
two other metrics of torch-fidelity, in NumPy on the host.

- ``kid_from_features``: the unbiased polynomial-kernel MMD^2 (degree 3,
  gamma 1/dim, coef0 1) averaged over random subsets, torch-fidelity's
  protocol (100 subsets of 1000, without replacement).
- ``isc_from_logits``: exp(E_x KL(p(y|x) || p(y))) over consecutive
  splits (10 by default) of the 1008-way logits, as mean and std.
"""

from __future__ import annotations

import warnings

import numpy as np


def _polynomial_kernel(x: np.ndarray, y: np.ndarray, degree: int,
                       gamma: float, coef0: float) -> np.ndarray:
    return (gamma * (x @ y.T) + coef0) ** degree


def polynomial_mmd2_unbiased(f1: np.ndarray, f2: np.ndarray,
                             degree: int = 3, gamma: float | None = None,
                             coef0: float = 1.0) -> float:
    """Unbiased MMD^2 between two equal-size feature sets (slightly
    negative values are possible for one distribution)."""
    m = f1.shape[0]
    if f2.shape[0] != m:
        raise ValueError("unbiased MMD^2 wants equal-size sets")
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    k_xx = _polynomial_kernel(f1, f1, degree, gamma, coef0)
    k_yy = _polynomial_kernel(f2, f2, degree, gamma, coef0)
    k_xy = _polynomial_kernel(f1, f2, degree, gamma, coef0)
    sum_off_xx = k_xx.sum() - np.trace(k_xx)
    sum_off_yy = k_yy.sum() - np.trace(k_yy)
    return float(sum_off_xx / (m * (m - 1)) + sum_off_yy / (m * (m - 1))
                 - 2.0 * k_xy.mean())


def kid_from_features(f1: np.ndarray, f2: np.ndarray, subsets: int = 100,
                      subset_size: int = 1000, degree: int = 3,
                      gamma: float | None = None, coef0: float = 1.0,
                      seed: int = 0) -> tuple[float, float]:
    """(mean, std) of the unbiased MMD^2 over random subsets: the KID.
    A set smaller than ``subset_size`` shrinks the subsets to its size,
    with a warning: torch-fidelity refuses that case, so such a value is
    not comparable with its KID."""
    f1 = np.asarray(f1, np.float64)
    f2 = np.asarray(f2, np.float64)
    m = min(subset_size, f1.shape[0], f2.shape[0])
    if m < 2:
        raise ValueError("KID needs at least 2 samples per set")
    if m < subset_size:
        warnings.warn(
            f"KID subset_size clamped {subset_size} -> {m} (set sizes "
            f"{f1.shape[0]}/{f2.shape[0]}): torch-fidelity errors here, so "
            "this value is not comparable to the fidelity CLI's KID",
            stacklevel=2)
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(subsets):
        i1 = rng.choice(f1.shape[0], m, replace=False)
        i2 = rng.choice(f2.shape[0], m, replace=False)
        vals.append(polynomial_mmd2_unbiased(f1[i1], f2[i2], degree=degree,
                                             gamma=gamma, coef0=coef0))
    vals = np.asarray(vals)
    return float(vals.mean()), float(vals.std())


def isc_from_logits(logits: np.ndarray, splits: int = 10,
                    eps: float = 1e-16) -> tuple[float, float]:
    """(mean, std) Inception Score of [N, n_classes] logits, over
    consecutive splits in input order."""
    logits = np.asarray(logits, np.float64)
    if logits.shape[0] < splits:
        raise ValueError(f"ISC wants >= {splits} samples, got"
                         f" {logits.shape[0]}")
    z = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    scores = []
    for chunk in np.array_split(p, splits, axis=0):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = chunk * (np.log(chunk + eps) - np.log(marginal + eps))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    scores = np.asarray(scores)
    return float(scores.mean()), float(scores.std())
