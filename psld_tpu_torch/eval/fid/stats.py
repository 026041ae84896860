"""FID statistics: streaming feature moments and the Frechet distance
(``psld_tpu/eval/fid/stats.py``).

Features accumulate as (count, sum, outer-product sum) in float64, so a
50k-sample run streams in constant memory and two runs merge by
addition. The matrix square root runs on the host through SciPy, with
pytorch-fid's ``np.cov(..., ddof=1)`` convention. A stats file holds
``mu``, ``sigma`` and ``count``, the JAX package's keys, so a file from
either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FeatureMoments:
    count: int
    feat_sum: np.ndarray      # [D]
    outer_sum: np.ndarray     # [D, D]

    @classmethod
    def zeros(cls, dim: int) -> "FeatureMoments":
        return cls(0, np.zeros(dim, np.float64),
                   np.zeros((dim, dim), np.float64))

    def update(self, feats) -> "FeatureMoments":
        f = np.asarray(feats, np.float64)
        return FeatureMoments(self.count + f.shape[0],
                              self.feat_sum + f.sum(axis=0),
                              self.outer_sum + f.T @ f)

    def merge(self, other: "FeatureMoments") -> "FeatureMoments":
        return FeatureMoments(self.count + other.count,
                              self.feat_sum + other.feat_sum,
                              self.outer_sum + other.outer_sum)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """(mu, cov) with the unbiased (ddof=1) covariance."""
        n = self.count
        mu = self.feat_sum / n
        cov = (self.outer_sum - n * np.outer(mu, mu)) / (n - 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2}); an ``eps`` ridge
    on both covariances where the root is not finite."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    cov1, cov2 = np.atleast_2d(cov1), np.atleast_2d(cov2)
    diff = mu1 - mu2
    # no ``disp``: SciPy 1.18 removed it, and it changes no value
    covmean = linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(covmean))


def save_stats(path: str, moments: FeatureMoments) -> None:
    mu, cov = moments.finalize()
    np.savez(path, mu=mu, sigma=cov, count=moments.count)


def load_stats(path: str) -> tuple[np.ndarray, np.ndarray]:
    with np.load(path) as d:
        return d["mu"], d["sigma"]
