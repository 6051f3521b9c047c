import numpy as np
import pytest

# sklearn is the oracle here, and optional (see tests/test_knn.py)
SkPCA = pytest.importorskip("sklearn.decomposition").PCA

from velocyto_tpu.ops import PCA


def test_pca_matches_sklearn(rng):
    X = rng.randn(120, 30).astype(np.float64)
    pcs = PCA(n_components=10).fit_transform(X)
    sk = SkPCA(n_components=10).fit_transform(X)
    np.testing.assert_allclose(np.abs(pcs), np.abs(sk), rtol=1e-3, atol=1e-3)
    # sign convention should match too (svd_flip)
    np.testing.assert_allclose(pcs, sk, rtol=1e-3, atol=1e-3)


def test_pca_explained_variance(rng):
    X = rng.randn(100, 20)
    p = PCA()
    p.fit(X)
    sk = SkPCA().fit(X)
    np.testing.assert_allclose(p.explained_variance_ratio_,
                               sk.explained_variance_ratio_,
                               rtol=1e-4, atol=1e-6)


def test_pca_gram_path_equals_svd_path(rng):
    """Tall data takes the Gram-eigh path; must equal full SVD exactly."""
    from velocyto_tpu.ops.pca import _pca_impl, _GRAM_RATIO
    X = rng.randn(300, 40) * rng.gamma(2.0, 2.0, 40)[None, :]
    assert X.shape[0] > _GRAM_RATIO * X.shape[1]
    pcs_g, vt_g, ev_g, tv_g = _pca_impl(X)
    # force the SVD path by transposing trickery: call the SVD directly
    mu = X.mean(0, keepdims=True)
    u, s, vt = np.linalg.svd(X - mu, full_matrices=False)
    from velocyto_tpu.ops.pca import _svd_flip_vt
    u, vt = _svd_flip_vt(u, vt)
    np.testing.assert_allclose(pcs_g, u * s[None, :], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(vt_g[:40], vt, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(ev_g, s ** 2 / (X.shape[0] - 1),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tv_g, (s ** 2).sum() / (X.shape[0] - 1),
                               rtol=1e-10)


def test_f32_gate_agreement_at_production_scale(rng, monkeypatch):
    """The default-on f32 Gram above the size gate must agree with the
    exact f64 path on a gated-size-representative spectrum (low-rank
    signal + Poisson-style noise floor, the production operating
    regime): explained-variance ratios, the leading well-separated
    subspace, and downstream kNN built on the PCs (round-4 advisor)."""
    from velocyto_tpu.ops.pca import _pca_impl
    # bench_pipeline.synth-shaped data: 12 latent dims over noise
    n, g, k_lat = 3000, 400, 12
    zl = rng.gamma(2.0, 1.0, (n, k_lat))
    wl = rng.gamma(2.0, 1.0, (k_lat, g))
    base = (zl @ wl) * rng.uniform(0.05, 0.6, g)[None, :]
    X = np.log2(rng.poisson(base).astype(np.float64) + 1)

    monkeypatch.setenv("VELOCYTO_PCA_F32", "1")
    pcs32, vt32, ev32, tv32 = _pca_impl(X, 50)
    monkeypatch.setenv("VELOCYTO_PCA_F32", "0")
    pcs64, vt64, ev64, tv64 = _pca_impl(X, 50)

    # explained-variance ratios: the quantity every gene-selection /
    # n-component decision reads
    np.testing.assert_allclose(ev32 / tv32, ev64 / tv64,
                               rtol=1e-4, atol=1e-7)
    # leading subspace (rotation-invariant): project f64 PCs onto the
    # f32 component basis and back -- residual must be at the f32
    # noise level for the well-separated latent block
    lead = k_lat
    proj = pcs64[:, :lead] @ (vt64[:lead] @ vt32[:lead].T)
    recon = proj @ (vt32[:lead] @ vt64[:lead].T)
    rel = np.linalg.norm(recon - pcs64[:, :lead]) / \
        np.linalg.norm(pcs64[:, :lead])
    assert rel < 1e-4, f"leading-subspace residual {rel:.2e}"
    # downstream kNN stability on the top PCs (what knn_imputation
    # consumes): neighbor sets must be essentially identical
    sample = rng.choice(n, 200, replace=False)
    d32 = np.linalg.norm(pcs32[sample, None, :lead] -
                         pcs32[None, :, :lead], axis=-1)
    d64 = np.linalg.norm(pcs64[sample, None, :lead] -
                         pcs64[None, :, :lead], axis=-1)
    nn32 = np.argsort(d32, axis=1)[:, :10]
    nn64 = np.argsort(d64, axis=1)[:, :10]
    overlap = np.mean([len(np.intersect1d(a, b)) / 10.0
                       for a, b in zip(nn32, nn64)])
    assert overlap >= 0.95, f"kNN overlap {overlap:.3f}"


def test_pca_subset_components_match_full(rng):
    """The dsyevr top-k subset path must equal the full decomposition."""
    from velocyto_tpu.ops.pca import _pca_impl
    X = rng.randn(400, 60) * rng.gamma(2.0, 2.0, 60)[None, :]
    pcs_k, vt_k, ev_k, tv_k = _pca_impl(X, 10)
    pcs_f, vt_f, ev_f, tv_f = _pca_impl(X)
    np.testing.assert_allclose(pcs_k, pcs_f[:, :10], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(vt_k, vt_f[:10], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(ev_k, ev_f[:10], rtol=1e-10)
    np.testing.assert_allclose(tv_k, tv_f, rtol=1e-12)
