import numpy as np
import pytest
from scipy import sparse

# sklearn is the oracle here, and optional: a host without it skips the
# module instead of failing collection for the whole suite
NearestNeighbors = pytest.importorskip("sklearn.neighbors").NearestNeighbors

from velocyto_tpu.ops import (knn_search, knn_balance, BalancedKNN,
                              knn_distance_matrix, make_mutual, take_top,
                              connectivity_to_weights,
                              convolve_by_sparse_weights)


def test_knn_search_matches_sklearn(rng):
    X = rng.randn(200, 10)
    dist, idx = knn_search(X, 8)
    nn = NearestNeighbors(n_neighbors=8).fit(X)
    sk_dist, sk_idx = nn.kneighbors(X)
    np.testing.assert_allclose(dist, sk_dist, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(idx, sk_idx)


def test_knn_search_correlation_metric(rng):
    X = rng.randn(100, 20)
    dist, idx = knn_search(X, 5, metric="correlation")
    nn = NearestNeighbors(n_neighbors=5, metric="correlation",
                          algorithm="brute").fit(X)
    sk_dist, sk_idx = nn.kneighbors(X)
    np.testing.assert_allclose(dist, sk_dist, rtol=1e-3, atol=1e-4)


def test_knn_search_large_k_sort_path(rng):
    """The balanced-kNN sight regime (k > 1024 -> full row sort on
    device) must match sklearn brute-force exactly, tie-breaks included."""
    n, d, k = 1500, 6, 1200
    X = rng.randn(n, d)
    dist, idx = knn_search(X, k)
    nn = NearestNeighbors(n_neighbors=k, algorithm="brute").fit(X)
    sk_dist, sk_idx = nn.kneighbors(X)
    np.testing.assert_array_equal(idx, sk_idx)
    # the large-k rescore uses the dot formulation (same as sklearn's
    # euclidean_distances): near-zero distances carry ~1e-7 absolute
    # noise from f64 cancellation on both sides
    np.testing.assert_allclose(dist, sk_dist, rtol=1e-6, atol=2e-7)


def test_knn_search_large_k_with_ties(rng):
    """Duplicate points force exact distance ties.  sklearn's order
    within a tie group is unspecified (argpartition); ours is
    deterministic (distance, index).  Distances must agree exactly and
    each tie group must contain the same index set."""
    base = rng.randn(40, 4)
    X = np.vstack([base, base[:20]])     # 20 exact duplicates
    k = 50
    dist, idx = knn_search(X, k)
    nn = NearestNeighbors(n_neighbors=k, algorithm="brute").fit(X)
    sk_dist, sk_idx = nn.kneighbors(X)
    np.testing.assert_allclose(dist, sk_dist, rtol=0, atol=1e-12)
    for r in range(X.shape[0]):
        # per distinct distance value, index sets must match; the last
        # group may straddle the k boundary, where any same-size subset
        # of the tied candidates is a valid truncation
        groups = {}
        for d, i, sd, si in zip(dist[r], idx[r], sk_dist[r], sk_idx[r]):
            groups.setdefault(round(d, 9), [set(), set()])
            groups[round(d, 9)][0].add(i)
            groups.setdefault(round(sd, 9), [set(), set()])
            groups[round(sd, 9)][1].add(si)
        d_bound = round(max(dist[r]), 9)
        for d, (ours, theirs) in groups.items():
            if d == d_bound:
                assert len(ours) == len(theirs), (r, d, ours, theirs)
            else:
                assert ours == theirs, (r, d, ours, theirs)
    # ours additionally guarantees index-ascending order within ties
    for r in range(X.shape[0]):
        for c in range(1, k):
            if dist[r, c] == dist[r, c - 1]:
                assert idx[r, c] > idx[r, c - 1]


def test_knn_search_sharded_matches_single(rng):
    from velocyto_tpu.ops import knn_search_sharded
    from velocyto_tpu.parallel import make_mesh
    mesh = make_mesh()      # 8 virtual CPU devices on the cells axis
    X = rng.randn(300, 8)
    for k in (10, 150):     # top_k path and (forced) sort path
        d1, i1 = knn_search(X, k)
        d2, i2 = knn_search_sharded(mesh, X, k)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, rtol=1e-12)


def _ref_balance_loop(dsi, dist, lsi, maxl, k, return_distance,
                      constraint=None):
    """Literal oracle of the greedy balancing semantics
    (see velocyto_tpu/ops/knn.py docstring)."""
    n, sight = dsi.shape
    dsi_new = -1 * np.ones((n, k + 1), np.int64)
    l = np.zeros(n, np.int64)
    dist_new = np.zeros((n, k + 1), np.float64)
    for i in range(n):
        el = lsi[i]
        p = 0
        j = 0
        for j in range(sight):
            if p >= k:
                break
            m = dsi[el, j]
            if el == m:
                dsi_new[el, 0] = el
                continue
            if constraint is not None and constraint[el] != constraint[m]:
                continue
            if l[m] >= maxl:
                continue
            dsi_new[el, p + 1] = m
            l[m] += 1
            if return_distance:
                dist_new[el, p + 1] = dist[el, j]
            p += 1
        if (j == sight - 1) and (p < k):
            while p < k:
                dsi_new[el, p + 1] = el
                dist_new[el, p + 1] = dist[el, 0]
                p += 1
    if not return_distance:
        dist_new = np.ones_like(dsi_new, np.float64)
    return dist_new, dsi_new, l


def test_knn_balance_semantics(rng):
    n, sight, k, maxl = 60, 20, 5, 7
    X = rng.randn(n, 3)
    dist, dsi = knn_search(X, sight)
    l = np.bincount(dsi.flat[:], minlength=n)
    lsi = np.argsort(l, kind="mergesort")[::-1]
    exp = _ref_balance_loop(dsi, dist, lsi, maxl, k, True)
    got = knn_balance(dsi, dist, maxl=maxl, k=k)
    for e, g in zip(exp, got):
        np.testing.assert_array_equal(np.asarray(e), np.asarray(g))
    # in-degree cap holds
    assert got[2].max() <= maxl


def test_knn_balance_constrained(rng):
    n, sight, k, maxl = 40, 15, 4, 5
    X = rng.randn(n, 3)
    groups = rng.randint(0, 3, size=n)
    dist, dsi = knn_search(X, sight)
    l = np.bincount(dsi.flat[:], minlength=n)
    lsi = np.argsort(l, kind="mergesort")[::-1]
    exp = _ref_balance_loop(dsi, dist, lsi, maxl, k, True, groups)
    got = knn_balance(dsi, dist, maxl=maxl, k=k, constraint=groups)
    for e, g in zip(exp, got):
        np.testing.assert_array_equal(np.asarray(e), np.asarray(g))


def test_balanced_knn_graph(rng):
    X = rng.randn(80, 5)
    bknn = BalancedKNN(k=6, sight_k=20, maxl=10)
    bknn.fit(X)
    g = bknn.kneighbors_graph(mode="distance")
    assert g.shape == (80, 80)
    assert (np.diff(g.indptr) == 7).all()


def test_mutual_knn_pipeline(rng):
    X = rng.randn(50, 4)
    knn = knn_distance_matrix(X, k=10, mode="distance")
    assert (np.diff(knn.indptr) == 10).all()
    mknn = make_mutual(knn)
    assert (mknn.toarray() != mknn.T.toarray()).sum() == 0
    top = take_top(mknn + sparse.eye(50), 5)
    assert max(len(r) for r in top.rows) <= 5


def test_convolve_by_sparse_weights(rng):
    n, g, k = 30, 12, 4
    data = rng.rand(g, n)
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(n)])
    conn = sparse.csr_matrix(
        (np.ones(n * k), idx.ravel(), np.arange(0, n * k + 1, k)), (n, n))
    w = connectivity_to_weights(conn)
    expected = sparse.csr_matrix.dot(data, w.T.tocsr())
    got = convolve_by_sparse_weights(data, w.tocsr())
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


def test_knn_smooth_weights(rng):
    from velocyto_tpu.ops import knn_smooth_weights
    g, n = 15, 60
    matrix = rng.rand(g, n)
    w, knn = knn_smooth_weights(matrix, k_search=12, k_mutual=6)
    assert knn.shape == (n, n)
    assert w.shape == (n, n)
    # rows sum to one (row-normalized connectivity incl. self)
    np.testing.assert_allclose(np.asarray(w.sum(axis=1)).ravel(), 1.0)
    # no row keeps more than k_mutual + 1 (self) entries
    assert (np.diff(w.tocsr().indptr) <= 7).all()
