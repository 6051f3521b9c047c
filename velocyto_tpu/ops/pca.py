"""PCA matching sklearn's sign convention.

Replaces reference perform_PCA (velocyto/analysis.py:678-702) which uses
sklearn.decomposition.PCA: center features, SVD, then sklearn's
``svd_flip`` (v-based, sklearn >= 1.5) so component signs agree with the
reference to numerical tolerance.

Two exact paths, both host LAPACK f64 (PCA is a once-per-pipeline stage
whose input lives on the host; whether a device Gram + eigh beats it on
a GPU is an open measurement):
  - wide/square data: full LAPACK SVD
  - tall data (cells >> genes, the production regime): Gram-matrix
    eigendecomposition -- one f64 BLAS *syrk* (half the dgemm flops,
    upper triangle only) + LAPACK dsyevr restricted to the top
    n_components eigenpairs + one (N, G) x (G, k) projection.
    Mathematically identical to the SVD (eigenvectors of Xc'Xc ARE the
    right singular vectors); the total variance for explained-ratio
    normalization is trace(Gram)/(n-1), so no full spectrum is needed
    (syrk + top-k eigh + k-column projection instead of a full eigh and
    an all-G projection).  Below the f32 gate the output is
    exact f64 LAPACK; above it (see the gate comment in `_pca_impl`)
    the f32 Gram agrees with f64 on explained-variance ratios and on
    the well-separated leading subspace, while eigenvectors inside
    noise-floor-degenerate clusters may rotate (pinned by
    tests/test_pca.py::test_f32_gate_agreement_at_production_scale).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _svd_flip_vt(u: Optional[np.ndarray], vt: np.ndarray
                 ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """sklearn svd_flip (v-based): each row of Vt gets a positive
    max-abs entry."""
    max_abs_cols = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), max_abs_cols])
    signs[signs == 0] = 1.0
    if u is not None:
        u = u * signs[None, :]
    return u, vt * signs[:, None]


_GRAM_RATIO = 1.5   # use the Gram path when samples > ratio * features


def _pca_impl(x, k: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """x: (samples, features); k: components to materialize (None = all).
    Returns (pcs (n, k), components (k, features), explained_var (k,),
    total_var) with total_var = sum of ALL eigenvalues / (n - 1)."""
    x_in = np.asarray(x)
    n, g = x_in.shape
    k = min(k or g, g, n)
    if n > _GRAM_RATIO * g:
        from scipy.linalg import blas as _blas, eigh as _eigh
        # single-precision Gram above ~1e10 multiply-adds: ssyrk runs
        # at about twice the dsyrk rate on x86 BLAS, and the Gram's f32
        # rounding perturbs well-separated eigenpairs by ~sqrt(n)*eps32
        # ~ 1e-5 relative -- inside every pinned tolerance (goldens pin
        # 1e-4 on explained ratios).  Caveat: eigenVECTORS inside
        # near-degenerate (noise-floor) clusters rotate by
        # noise/eigengap, which can be large -- exactly as they do
        # under any other f32-level perturbation of the input (see
        # tests/test_golden_estimation_realistic.py).  Set
        # VELOCYTO_PCA_F32=0 to force the exact f64 path at any size
        # (or =1 to force f32); below the gate everything is LAPACK
        # f64, so reference-parity fixtures see exact doubles.
        import os
        _env = os.environ.get("VELOCYTO_PCA_F32", "").strip()
        if _env in ("0", "1"):
            use_f32 = _env == "1"
        else:
            use_f32 = n * g * g >= 1e10
        mu = np.mean(x_in, axis=0, keepdims=True, dtype=np.float64)
        if use_f32:
            xc = np.asarray(x_in, np.float32) - mu.astype(np.float32)
            c = np.asarray(_blas.ssyrk(1.0, xc, trans=1), np.float64)
        else:
            xc = np.asarray(x_in, np.float64) - mu
            c = _blas.dsyrk(1.0, xc, trans=1)   # upper triangle Xc'Xc
        total_var = float(np.trace(c)) / (n - 1)
        if k < g:
            evals, evecs = _eigh(c, lower=False,
                                 subset_by_index=[g - k, g - 1])
        else:
            evals, evecs = _eigh(c, lower=False)
        order = np.argsort(evals)[::-1]
        evals = np.maximum(evals[order], 0.0)
        vt = evecs[:, order].T              # rows = components
        _, vt = _svd_flip_vt(None, vt)
        pcs = np.asarray(
            xc @ (vt.T.astype(xc.dtype)), np.float64)
        return pcs, vt, evals / (n - 1), total_var
    x = np.asarray(x_in, dtype=np.float64)
    mu = np.mean(x, axis=0, keepdims=True)
    xc = x - mu
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    u, vt = _svd_flip_vt(u, vt)
    expl = (s ** 2) / (n - 1)
    total_var = float(expl.sum())
    return (u[:, :k] * s[None, :k], vt[:k], expl[:k], total_var)


class PCA:
    """Minimal sklearn-compatible PCA facade used by the analysis layer."""

    def __init__(self, n_components: Optional[int] = None) -> None:
        self.n_components = n_components

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        # no eager f64 copy: _pca_impl picks its own working dtype, and
        # the input is typically a strided transpose view of the (G, N)
        # f32 state -- materializing it as f64 here cost an 800 MB
        # strided copy (~3-5 s at 50k x 2k) before any math ran
        X = np.asarray(X)
        k = self.n_components or min(X.shape)
        pcs, comps, expl, total_var = _pca_impl(X, k)
        self.components_ = comps
        self.explained_variance_ = expl
        self.explained_variance_ratio_ = expl / total_var
        self.mean_ = np.mean(X, axis=0, dtype=np.float64)
        return pcs

    def fit(self, X: np.ndarray) -> "PCA":
        self.fit_transform(X)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X) - self.mean_) @ self.components_.T
