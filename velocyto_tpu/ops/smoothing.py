"""kNN smoothing (imputation) of count matrices.

The reference smooths with a sparse weight matrix product
(reference: velocyto/neighbors.py:385-423, analysis.py:1006-1016).
On the device the compact (N, K) neighbor form (<= K neighbors per cell)
is contracted blocked over cells (see ops.knn_device._smooth_rows_impl),
which shards trivially over the cells axis.

The scipy.sparse-facing helpers keep API parity for host-side use.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse


def connectivity_to_weights(mknn: sparse.spmatrix, axis: int = 1) -> sparse.spmatrix:
    """Row-normalize a binary connectivity matrix
    (reference: velocyto/neighbors.py:385-390)."""
    if not sparse.issparse(mknn) or mknn.format != "csr":
        mknn = sparse.csr_matrix(mknn)
    return mknn.multiply(1.0 / np.array(mknn.sum(axis=axis)))


def csr_to_compact(w: sparse.spmatrix) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a sparse row-stochastic weight matrix to (N, Kmax) index/weight
    arrays.  Padding entries have weight 0 (index 0, harmless)."""
    w = sparse.csr_matrix(w)
    n = w.shape[0]
    counts = np.diff(w.indptr)
    kmax = int(counts.max()) if n else 0
    idx = np.zeros((n, kmax), dtype=np.int32)
    wgt = np.zeros((n, kmax), dtype=np.float32)
    for i in range(n):
        s, e = w.indptr[i], w.indptr[i + 1]
        idx[i, :e - s] = w.indices[s:e]
        wgt[i, :e - s] = w.data[s:e]
    return idx, wgt


def _convolve_compact_impl(data_rows: jax.Array, nbr_idx: jax.Array,
                           nbr_w: jax.Array, block: int = 2048) -> jax.Array:
    """out[i] = sum_k w[i,k] * data_rows[idx[i,k]].

    data_rows: (N, G); nbr_idx/nbr_w: (N, K).  Returns (N, G).
    One kernel shared with ops.knn_device (blocked scatter-to-dense +
    matmul -- see _smooth_rows_impl there for the rationale)."""
    from .knn_device import _smooth_rows_impl
    return _smooth_rows_impl(data_rows, nbr_idx, nbr_w, block=block)


@jax.jit
def _convolve_dense_impl(data_rows: jax.Array, w_dense: jax.Array
                         ) -> jax.Array:
    return jnp.matmul(w_dense, data_rows,
                      precision=jax.lax.Precision.HIGHEST)


# Below this many cells, one dense (N, N) weight matmul replaces the
# blocked path outright (the weight matrix is small at these sizes).
_DENSE_N_MAX = 8192


def convolve_by_sparse_weights(data: np.ndarray, w: sparse.spmatrix) -> np.ndarray:
    """data (genes, cells) smoothed with weights w so that
    out[:, i] = sum_j w[i, j] data[:, j]  (reference expects w.T applied on
    the right: velocyto/neighbors.py:416-423, where w is (cells, cells)
    row-stochastic).
    """
    w_ = w.T
    colsums = np.array(w_.sum(0)).ravel()
    assert np.allclose(colsums, 1), \
        "weight matrix need to sum to one over the columns"
    data_rows = jnp.array(np.ascontiguousarray(data.T), dtype=jnp.float32)
    n = data.shape[1]
    if n <= _DENSE_N_MAX:
        w_dense = jnp.array(sparse.csr_matrix(w).toarray(),
                            dtype=jnp.float32)
        out_rows = _convolve_dense_impl(data_rows, w_dense)
    else:
        idx, wgt = csr_to_compact(sparse.csr_matrix(w))
        out_rows = _convolve_compact_impl(data_rows, jnp.array(idx),
                                          jnp.array(wgt))
    return np.array(out_rows, dtype=np.float64).T


def convolve_compact(data_rows: np.ndarray, nbr_idx: np.ndarray,
                     nbr_w: np.ndarray) -> np.ndarray:
    """Direct compact-form smoothing (cells-as-rows)."""
    return np.array(_convolve_compact_impl(
        jnp.array(data_rows, dtype=jnp.float32),
        jnp.array(nbr_idx, dtype=jnp.int32),
        jnp.array(nbr_w, dtype=jnp.float32)))
