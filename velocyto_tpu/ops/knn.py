"""k-nearest-neighbor search and balanced-kNN graph construction.

The kNN search runs on the device: blocked pairwise distances as one
matmul per row block (||x-y||^2 = ||x||^2 + ||y||^2 - 2 x.y) followed by
a blocked stable row sort (see _candidate_plan for why not
``lax.top_k``).  This
replaces the reference's sklearn NearestNeighbors calls
(reference: velocyto/neighbors.py:226-244,363-376).

The balanced-kNN *balancing* step is a greedy, order-dependent algorithm
(reference: velocyto/neighbors.py:11-140, numba).  This module holds the
HOST implementations (C++ via native/, numpy fallback), used when the
caller wants host-resident results; the device-resident pipeline uses
the bit-equal speculative batched scan in ops/knn_device.py instead.
The numpy implementation below reproduces the reference semantics
exactly, including tie-breaking (mergesort argsort reversed) and the
self-fill behavior when the sight is exhausted.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse

from .. import native


# ---------------------------------------------------------------------------
# device kNN search
# ---------------------------------------------------------------------------

def _normalize_for_metric(x: jax.Array, metric: str) -> jax.Array:
    if metric == "correlation":
        x = x - jnp.mean(x, axis=1, keepdims=True)
        x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
        # correlation distance = 1 - corr; monotone in squared euclidean of
        # the normalized rows: ||u-v||^2 = 2 (1 - corr)
    return x


def _candidate_block_fn(x: jax.Array, sq: jax.Array, x_p: jax.Array,
                        sq_p: jax.Array, k: int, block: int, use_sort: bool):
    """Returns block_fn(r0) -> (d2 (B, k), idx (B, k)), the k nearest
    candidates for one row block against the full data.

    Each row block is fully sorted (stable two-key sort, so ties
    break by index like sklearn) and the first k columns are kept.
    The top_k branch is kept for reference but unused (see
    _candidate_plan).
    """
    n, d = x.shape

    def block_fn(r0):
        rows = jax.lax.dynamic_slice(x_p, (r0, 0), (block, d))
        rsq = jax.lax.dynamic_slice(sq_p, (r0,), (block,))
        # HIGHEST precision is load-bearing: a reduced-precision matrix
        # unit pass (bf16 ~4e-3 or TF32 ~1e-3 relative) displaces
        # boundary candidates by dozens of ranks at 50k cells - beyond
        # the +8 margin the exact f64 re-score assumes.  True f32 keeps
        # displacement within a couple of ranks.
        d2 = rsq[:, None] + sq[None, :] - 2.0 * jnp.matmul(
            rows, x.T, precision=jax.lax.Precision.HIGHEST)   # (B, N)
        d2 = jnp.maximum(d2, 0.0)
        if use_sort:
            idx = jax.lax.broadcasted_iota(jnp.int32, (block, n), 1)
            d2_s, idx_s = jax.lax.sort((d2, idx), num_keys=1,
                                       is_stable=True)
            return d2_s[:, :k], idx_s[:, :k]
        neg, idx = jax.lax.top_k(-d2, k)
        return -neg, idx

    return block_fn


@functools.partial(jax.jit,
                   static_argnames=("k", "block", "metric", "use_sort"))
def _knn_search_impl(data: jax.Array, k: int, block: int = 512,
                     metric: str = "euclidean", use_sort: bool = False
                     ) -> Tuple[jax.Array, jax.Array]:
    """All-pairs kNN of data (N, D) against itself; returns (dist, idx)
    each (N, k), ascending by distance, self included (distance 0 first,
    matching sklearn kneighbors on the fit data)."""
    n, d = data.shape
    x = _normalize_for_metric(data.astype(jnp.float32), metric)
    sq = jnp.sum(x * x, axis=1)
    n_pad = ((n + block - 1) // block) * block
    x_p = jnp.pad(x, ((0, n_pad - n), (0, 0)))
    sq_p = jnp.pad(sq, ((0, n_pad - n),))

    block_fn = _candidate_block_fn(x, sq, x_p, sq_p, k, block, use_sort)
    dists2, idx = jax.lax.map(block_fn, jnp.arange(0, n_pad, block))
    dists2 = dists2.reshape(n_pad, k)[:n]
    idx = idx.reshape(n_pad, k)[:n]
    if metric == "correlation":
        dist = dists2 / 2.0           # 1 - corr
    else:
        dist = jnp.sqrt(dists2)
    return dist, idx


def _chunked_rescore(x64: np.ndarray, idx: np.ndarray,
                     rows: int = 256) -> np.ndarray:
    """Exact f64 squared distances of gathered candidates, row-chunked.

    Small k: gather (rows, k, D) + elementwise (memory ~rows*k*D).
    Large k (balanced-kNN sight windows): the gather would stream tens
    of GB, so instead one f64 BLAS GEMM per chunk computes all-pairs
    dots and the candidates are selected from it -- more flops,
    ~10x less memory traffic, measured ~5x faster at 20k x 3000.
    """
    n, k = idx.shape
    d2 = np.empty(idx.shape, dtype=np.float64)
    if k > max(256, n // 16):
        sq = np.einsum("nd,nd->n", x64, x64)
        xt = np.ascontiguousarray(x64.T)
        for lo in range(0, n, rows):
            hi = min(n, lo + rows)
            dots = x64[lo:hi] @ xt                        # (B, N) BLAS
            dsel = np.take_along_axis(dots, idx[lo:hi], axis=1)
            d2[lo:hi] = sq[lo:hi, None] + sq[idx[lo:hi]] - 2.0 * dsel
        np.maximum(d2, 0.0, out=d2)
        return d2
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        diff = x64[idx[lo:hi]] - x64[lo:hi, None, :]
        d2[lo:hi] = np.einsum("nkd,nkd->nk", diff, diff)
    return d2


def _exact_rescore_topk(x64: np.ndarray, idx: np.ndarray, k: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact f64 re-score of candidate indices + lexicographic
    (distance, index) ordering, truncated to k (matches sklearn's exact
    brute-force tie-breaking)."""
    d2 = _chunked_rescore(x64, idx)
    # lexicographic (distance, index): sort by index first, then
    # stable by d2
    by_idx = np.argsort(idx, axis=1, kind="stable")
    idx = np.take_along_axis(idx, by_idx, axis=1)
    d2 = np.take_along_axis(d2, by_idx, axis=1)
    order = np.argsort(d2, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)[:, :k]
    d2 = np.take_along_axis(d2, order, axis=1)[:, :k]
    return d2, idx


def _candidate_plan(n: int, k: int, block: int) -> Tuple[int, int, bool]:
    """(k2, block, use_sort) for the device candidate pass: a +8 margin
    absorbs f32 rounding at the k boundary; the block shrinks with n to
    bound the (B, N) distance buffer (~256 MB at f32 incl. sort
    scratch).

    use_sort is ALWAYS True: the full two-key stable row sort costs
    O(N log N) per row against top_k's O(N k), but it gives
    sklearn-identical index tie-breaking directly, which the exact
    re-score relies on.  The block shrinks as N grows so the (B, N)
    sort scratch stays bounded."""
    k2 = min(n, k + 8)
    use_sort = True
    if n > 32768:
        block = min(block, 128)
    elif n > 16384:
        block = min(block, 256)
    return k2, max(8, min(block, n)), use_sort


def _pull_idx(idx_dev: jax.Array, n: int) -> np.ndarray:
    """Device->host transfer of a candidate index matrix.

    The (N, sight) index pull is the only large readback of the kNN
    path; when indices fit in uint16 (N <= 65536) the cast runs on
    device and halves the bytes transferred."""
    if n <= 65536:
        return np.asarray(idx_dev.astype(jnp.uint16)).astype(np.int64)
    return np.asarray(idx_dev, dtype=np.int64)


def knn_search(data: np.ndarray, k: int, metric: str = "euclidean",
               block: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """kNN search (self included as the first neighbor).

    Device blocked-matmul candidate pass (f32, full stable row sort)
    + exact f64 host re-score, so ordering matches an exact search
    (sklearn brute force) including tie-breaks.
    """
    n = data.shape[0]
    k = min(k, n)
    x64 = np.asarray(data, dtype=np.float64)
    if metric == "correlation":
        x64 = x64 - x64.mean(axis=1, keepdims=True)
        x64 = x64 / np.linalg.norm(x64, axis=1, keepdims=True)

    k2, block, use_sort = _candidate_plan(n, k, block)
    _dist, idx = _knn_search_impl(jnp.asarray(data, dtype=jnp.float32),
                                  k2, block, metric, use_sort)
    idx = _pull_idx(idx, n)
    d2, idx = _exact_rescore_topk(x64, idx, k)
    if metric == "correlation":
        dist = d2 / 2.0                            # 1 - corr
    else:
        dist = np.sqrt(np.maximum(d2, 0.0))
    return dist, idx


def make_knn_search_sharded(mesh, k: int, block: int = 256,
                            metric: str = "euclidean", use_sort: bool = True):
    """Build a shard_map'd kNN candidate pass over `mesh`: query rows
    sharded on the CELLS axis, data replicated; each shard runs the same
    blocked distance + sort/top_k merge collective-free.  Returns
    fn(data (N, D), rows (Np, D), rows_sq (Np,)) -> (d2, idx) (Np, k)."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from ..parallel.mesh import CELLS

    def shard_fn(x, rows_shard, sq_shard):
        m, d = rows_shard.shape
        n = x.shape[0]
        sq = jnp.sum(x * x, axis=1)
        b = max(8, min(block, m))
        m_pad = ((m + b - 1) // b) * b
        rows_p = jnp.pad(rows_shard, ((0, m_pad - m), (0, 0)))
        sq_p = jnp.pad(sq_shard, ((0, m_pad - m),))

        def block_fn(r0):
            rws = jax.lax.dynamic_slice(rows_p, (r0, 0), (b, d))
            rsq = jax.lax.dynamic_slice(sq_p, (r0,), (b,))
            d2 = rsq[:, None] + sq[None, :] - 2.0 * jnp.matmul(
                rws, x.T, precision=jax.lax.Precision.HIGHEST)
            d2 = jnp.maximum(d2, 0.0)
            if use_sort:
                ii = jax.lax.broadcasted_iota(jnp.int32, (b, n), 1)
                d2_s, idx_s = jax.lax.sort((d2, ii), num_keys=1,
                                           is_stable=True)
                return d2_s[:, :k], idx_s[:, :k]
            neg, ii = jax.lax.top_k(-d2, k)
            return -neg, ii

        d2, idx = jax.lax.map(block_fn, jnp.arange(0, m_pad, b))
        return d2.reshape(m_pad, k)[:m], idx.reshape(m_pad, k)[:m]

    return shard_map(shard_fn, mesh=mesh,
                     in_specs=(P(), P(CELLS, None), P(CELLS)),
                     out_specs=(P(CELLS, None), P(CELLS, None)))


def knn_search_sharded(mesh, data: np.ndarray, k: int,
                       metric: str = "euclidean", block: int = 256
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-chip kNN search: query rows sharded over the mesh CELLS
    axis, data replicated (collective-free).  Same
    exact f64 re-score + tie-breaking as knn_search, so the result is
    identical to the single-device path."""
    n = data.shape[0]
    k = min(k, n)
    x64 = np.asarray(data, dtype=np.float64)
    if metric == "correlation":
        x64 = x64 - x64.mean(axis=1, keepdims=True)
        x64 = x64 / np.linalg.norm(x64, axis=1, keepdims=True)

    from ..parallel.mesh import CELLS
    k2, block, use_sort = _candidate_plan(n, k, block)
    shards = mesh.shape[CELLS]
    n_pad = ((n + shards - 1) // shards) * shards
    x32 = _normalize_for_metric(jnp.asarray(data, dtype=jnp.float32), metric)
    rows_p = jnp.pad(x32, ((0, n_pad - n), (0, 0)))
    sq_p = jnp.sum(rows_p * rows_p, axis=1)
    fn = make_knn_search_sharded(mesh, k2, block, metric, use_sort)
    _d2, idx = fn(x32, rows_p, sq_p)
    idx = _pull_idx(idx, n)[:n]
    d2, idx = _exact_rescore_topk(x64, idx, k)
    if metric == "correlation":
        dist = d2 / 2.0
    else:
        dist = np.sqrt(np.maximum(d2, 0.0))
    return dist, idx


@functools.partial(jax.jit, static_argnames=("k", "block"))
def _knn_query_jit(data: jax.Array, query: jax.Array, k: int,
                   block: int = 512) -> Tuple[jax.Array, jax.Array]:
    m, d = query.shape
    sq_d = jnp.sum(data * data, axis=1)
    m_pad = ((m + block - 1) // block) * block
    q_p = jnp.pad(query, ((0, m_pad - m), (0, 0)))

    def block_fn(r0):
        rows = jax.lax.dynamic_slice(q_p, (r0, 0), (block, d))
        d2 = jnp.sum(rows * rows, axis=1)[:, None] + sq_d[None, :] \
            - 2.0 * jnp.matmul(rows, data.T,
                               precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.maximum(d2, 0.0)
        # stable sort, not top_k: see _candidate_plan
        n_data = data.shape[0]
        ii = jax.lax.broadcasted_iota(jnp.int32, (block, n_data), 1)
        d2_s, idx_s = jax.lax.sort((d2, ii), num_keys=1, is_stable=True)
        return d2_s[:, :k], idx_s[:, :k]

    d2, idx = jax.lax.map(block_fn, jnp.arange(0, m_pad, block))
    return (jnp.sqrt(d2.reshape(m_pad, k)[:m]),
            idx.reshape(m_pad, k)[:m])


def _knn_query_impl(data: np.ndarray, query: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """kNN of `query` rows against `data` rows (euclidean), with the same
    exact f64 re-scoring as knn_search."""
    n = data.shape[0]
    k2 = min(n, k + 8)
    _d, idx = _knn_query_jit(jnp.asarray(data, dtype=jnp.float32),
                             jnp.asarray(query, dtype=jnp.float32), k2,
                             min(512, max(8, query.shape[0])))
    idx = _pull_idx(idx, n)
    x = np.asarray(data, dtype=np.float64)
    q = np.asarray(query, dtype=np.float64)
    d2 = np.empty(idx.shape, dtype=np.float64)
    for lo in range(0, len(q), 256):
        hi = min(len(q), lo + 256)
        diff = x[idx[lo:hi]] - q[lo:hi, None, :]
        d2[lo:hi] = np.einsum("nkd,nkd->nk", diff, diff)
    by_idx = np.argsort(idx, axis=1, kind="stable")
    idx = np.take_along_axis(idx, by_idx, axis=1)
    d2 = np.take_along_axis(d2, by_idx, axis=1)
    order = np.argsort(d2, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)[:, :k]
    d2 = np.take_along_axis(d2, order, axis=1)[:, :k]
    return np.sqrt(np.maximum(d2, 0.0)), idx


# ---------------------------------------------------------------------------
# Greedy balancing (host; reference-exact semantics)
# ---------------------------------------------------------------------------

def balance_knn_loop(dsi: np.ndarray, dist: np.ndarray, lsi: np.ndarray,
                     maxl: int, k: int, return_distance: bool,
                     constraint: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy cap on in-degree of the kNN graph.

    Mirrors reference velocyto/neighbors.py:11-140 (both the plain and the
    group-constrained variant, selected by ``constraint``): nodes are
    visited hub-first (lsi); each keeps its first k admissible neighbors,
    where a neighbor is admissible if its in-degree is still < maxl (and,
    if constrained, shares the node's group); exhausted sights self-fill.

    The numpy fallback below is TRANSCRIBED from the reference numba
    loop for semantic parity: the greedy visit order and its tie-breaks
    ARE the specification, so the loop intentionally matches it
    line-by-line.  The production path is the from-scratch C++
    implementation (native/vtpu.cpp).
    """
    if native.available():
        return native.balance_knn_loop(dsi, dist, lsi, maxl, k,
                                       return_distance, constraint)
    n, sight = dsi.shape
    assert sight >= k, "sight needs to be bigger than k"
    dsi_new = -1 * np.ones((n, k + 1), np.int64)
    l = np.zeros(n, np.int64)
    dist_new = np.zeros((n, k + 1), np.float64)
    for i in range(n):
        el = lsi[i]
        p = 0
        j = 0
        row = dsi[el]
        for j in range(sight):
            if p >= k:
                break
            m = row[j]
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


def balance_knn_loop_constrained(dsi: np.ndarray, dist: np.ndarray,
                                 lsi: np.ndarray, groups: np.ndarray,
                                 maxl: int, k: int, return_distance: bool
                                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference-name alias (velocyto/neighbors.py:77-140): the constrained
    variant is folded into balance_knn_loop via ``constraint``."""
    return balance_knn_loop(dsi, dist, lsi, maxl, k, return_distance,
                            constraint=groups)


def knn_balance(dsi: np.ndarray, dist: Optional[np.ndarray] = None,
                maxl: int = 200, k: int = 60,
                constraint: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference-parity wrapper (velocyto/neighbors.py:143-183)."""
    l = np.bincount(dsi.flat[:], minlength=dsi.shape[0])
    lsi = np.argsort(l, kind="mergesort")[::-1]
    if dist is None:
        dist = np.ones(dsi.shape, dtype="float64")
        dist[:, 0] = 0
        cst = None if constraint is None else constraint.astype("int64")
        return balance_knn_loop(dsi, dist, lsi, maxl, k,
                                return_distance=False, constraint=cst)
    cst = None if constraint is None else constraint.astype("int64")
    return balance_knn_loop(dsi, dist, lsi, maxl, k,
                            return_distance=True, constraint=cst)


class BalancedKNN:
    """sklearn-like estimator for the balanced kNN graph.

    API parity with reference velocyto/neighbors.py:186-357, but the
    initial kNN search runs on the device (blocked matmul + stable sort).
    """

    def __init__(self, k: int = 50, sight_k: int = 100, maxl: int = 200,
                 constraint: Optional[np.ndarray] = None,
                 mode: str = "distance", metric: str = "euclidean",
                 n_jobs: int = 4, mesh=None) -> None:
        self.k = k
        self.sight_k = sight_k
        self.maxl = maxl
        self.mode = mode
        self.metric = metric
        self.n_jobs = n_jobs
        self.mesh = mesh      # optional jax Mesh: shard the search
        self.dist_new = self.dsi_new = self.l = None
        self.bknn: Optional[sparse.csr_matrix] = None
        self.constraint = constraint

    @property
    def n_samples(self) -> int:
        return self.data.shape[0]

    def fit(self, data: np.ndarray, sight_k: Optional[int] = None) -> "BalancedKNN":
        self.data = data
        self.fitdata = data
        if sight_k is not None:
            self.sight_k = sight_k
        return self

    def kneighbors(self, X: Optional[np.ndarray] = None,
                   maxl: Optional[int] = None, mode: str = "distance"):
        if X is not None:
            self.data = X
        if maxl is not None:
            self.maxl = maxl
        kk = min(self.sight_k + 1, self.fitdata.shape[0])
        if self.mesh is not None:
            self.dist, self.dsi = knn_search_sharded(self.mesh, self.fitdata,
                                                     kk, metric=self.metric)
        else:
            self.dist, self.dsi = knn_search(self.fitdata, kk,
                                             metric=self.metric)
        self.dist_new, self.dsi_new, self.l = knn_balance(
            self.dsi, self.dist, maxl=self.maxl, k=self.k,
            constraint=self.constraint)
        if mode == "connectivity":
            self.dist = np.ones_like(self.dsi)
            self.dist[:, 0] = 0
        return self.dist_new, self.dsi_new, self.l

    def kneighbors_graph(self, X: Optional[np.ndarray] = None,
                         maxl: Optional[int] = None,
                         mode: str = "distance") -> sparse.csr_matrix:
        dist_new, dsi_new, _l = self.kneighbors(X=X, maxl=maxl, mode=mode)
        self.bknn = sparse.csr_matrix(
            (np.ravel(dist_new), np.ravel(dsi_new),
             np.arange(0, dist_new.shape[0] * dist_new.shape[1] + 1,
                       dist_new.shape[1])),
            (self.n_samples, self.n_samples))
        return self.bknn

    def smooth_data(self, data_to_smooth: np.ndarray,
                    X: Optional[np.ndarray] = None,
                    maxl: Optional[int] = None,
                    mutual: bool = False,
                    only_increase: bool = True) -> np.ndarray:
        from .smoothing import connectivity_to_weights, convolve_by_sparse_weights
        if self.bknn is None:
            assert (X is None) and (maxl is None), \
                "graph was already fit with different parameters"
            self.kneighbors_graph(X=X, maxl=maxl, mode=self.mode)
        if mutual:
            connectivity = make_mutual(self.bknn > 0)
        else:
            connectivity = self.bknn.T > 0
        connectivity = connectivity.tolil()
        connectivity.setdiag(1)
        w = connectivity_to_weights(connectivity).T
        assert np.allclose(w.sum(0), 1), \
            "weight matrix need to sum to one over the columns"
        if data_to_smooth.shape[1] == w.shape[0]:
            result = sparse.csr_matrix.dot(data_to_smooth, w)
        elif data_to_smooth.shape[0] == w.shape[0]:
            result = sparse.csr_matrix.dot(data_to_smooth.T, w).T
        else:
            raise ValueError(
                f"Incorrect size of matrix, none of the axis correspond "
                f"to the one of graph. {w.shape}")
        if only_increase:
            return np.maximum(result, data_to_smooth)
        return result


# ---------------------------------------------------------------------------
# Mutual kNN utilities (reference velocyto/neighbors.py:363-451)
# ---------------------------------------------------------------------------

def knn_distance_matrix(data: np.ndarray, metric: Optional[str] = None,
                        k: int = 40, mode: str = "connectivity",
                        n_jobs: int = 4, mesh=None) -> sparse.csr_matrix:
    """kNN graph of data (samples, features) *excluding* self, like
    sklearn kneighbors_graph(X=None)."""
    metric = metric or "euclidean"
    kk = min(k + 1, data.shape[0])
    if mesh is not None:
        dist, idx = knn_search_sharded(mesh, data, kk, metric=metric)
    else:
        dist, idx = knn_search(data, kk, metric=metric)
    # drop the self column
    dist, idx = dist[:, 1:], idx[:, 1:]
    n, kk = idx.shape
    if mode == "connectivity":
        data_vals = np.ones(n * kk)
    else:
        data_vals = dist.ravel()
    return sparse.csr_matrix(
        (data_vals, idx.ravel(), np.arange(0, n * kk + 1, kk)), (n, n))


def make_mutual(knn: sparse.spmatrix) -> sparse.coo_matrix:
    """Keep only mutual edges (reference neighbors.py:379-382)."""
    return knn.minimum(knn.T)


def min_n(row_data: np.ndarray, row_indices: np.ndarray, n: int):
    i = row_data.argsort()[:n]
    return row_data[i], row_indices[i]


def take_top(matrix: sparse.spmatrix, n: int) -> sparse.lil_matrix:
    """Keep the n smallest entries of each row (reference :403-411)."""
    arr_ll = matrix.tolil(copy=True)
    for i in range(arr_ll.shape[0]):
        d, r = min_n(np.array(arr_ll.data[i]), np.array(arr_ll.rows[i]), n)
        arr_ll.data[i] = d.tolist()
        arr_ll.rows[i] = r.tolist()
    return arr_ll


def knn_smooth_weights(matrix: np.ndarray, metric: str = "euclidean",
                       k_search: int = 20, k_mutual: int = 10,
                       n_jobs: int = 10
                       ) -> Tuple[sparse.spmatrix, sparse.csr_matrix]:
    """Mutual-kNN smoothing weights for a (genes, cells) expression matrix
    (reference velocyto/neighbors.py:426-451): kNN search (device) ->
    mutualize -> keep k_mutual smallest per row -> row-normalize."""
    assert k_search >= k_mutual, "k_search needs to be bigger than k_mutual"
    from .smoothing import connectivity_to_weights
    knn = knn_distance_matrix(matrix.T, metric=metric, k=k_search,
                              mode="distance", n_jobs=n_jobs)
    mknn = make_mutual(knn)
    top_mknn = take_top(mknn, k_mutual)
    top_mknn.setdiag(1)
    connectivity = top_mknn > 0
    w = connectivity_to_weights(connectivity)
    return w, knn
