"""Markov diffusion on the embedding (reference velocyto/diffusion.py).

The transition-matrix construction keeps the reference's scipy.sparse
contract for small host-side use; the repeated sparse-vector/matrix
products of `diffuse` run as a jitted dense scan on the device (cells x
cells at analysis scale fits device memory).  Both scans multiply at
``Precision.HIGHEST``: true float32, never a reduced-precision (TF32 or
bf16) matrix unit pass.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse
from scipy.stats import norm

from .ops.knn import knn_search


def _l1_normalize_rows(m: sparse.spmatrix) -> sparse.csr_matrix:
    m = sparse.csr_matrix(m)
    sums = np.asarray(np.abs(m).sum(axis=1)).ravel()
    sums[sums == 0] = 1.0
    d = sparse.diags(1.0 / sums)
    return sparse.csr_matrix(d @ m)


import functools


_HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("n_steps",))
def _power_steps(x: jax.Array, tr: jax.Array, n_steps: int) -> jax.Array:
    """x @ tr^n_steps (time_evolution)."""
    def body(carry, _):
        return jnp.matmul(carry, tr, precision=_HIGHEST), None
    out, _ = jax.lax.scan(body, x, None, length=n_steps)
    return out


@functools.partial(jax.jit, static_argnames=("n_steps",))
def _path_integral(x: jax.Array, tr: jax.Array, n_steps: int) -> jax.Array:
    """sum over t = 1..n_steps of x @ tr^t (path_integral)."""
    def body(carry, _):
        nxt = jnp.matmul(carry, tr, precision=_HIGHEST)
        return nxt, nxt
    _, traj = jax.lax.scan(body, x, None, length=n_steps)
    return jnp.sum(traj, axis=0)


class Diffusion:
    """Markov diffusion driver (reference diffusion.py:10-135)."""

    def compute_transition_matrix2(self, x0: np.ndarray, v: np.ndarray,
                                   sigma: float = 0.0,
                                   reverse: bool = False) -> sparse.csr_matrix:
        """Gaussian-kernel transitions from extrapolated positions
        (reference diffusion.py:14-53)."""
        n_cells = x0.shape[0]
        n_neighbors = min(20, n_cells)
        x1 = x0 - v if reverse else x0 + v
        # kNN of the *extrapolated* positions against the current ones
        # (reference fits sklearn NN on x0 and queries x1 at any scale);
        # small N runs a dense host argsort, large N the blocked device
        # query kernel with exact f64 re-scoring -- same neighbor sets.
        if n_cells <= 4096:
            dists = np.linalg.norm(
                x1[:, None, :] - x0[None, :, :], axis=-1)
            nearest = np.argsort(dists, axis=1)[:, :n_neighbors]
            dvals = np.take_along_axis(dists, nearest, axis=1)
        else:
            from .ops.knn import _knn_query_impl
            dvals, nearest = _knn_query_impl(x0, x1, n_neighbors)
        probs = norm.pdf(dvals.ravel(), 0, sigma)
        cells = np.repeat(np.arange(n_cells), n_neighbors)
        tr = sparse.coo_matrix((probs, (cells, nearest.ravel())),
                               shape=(n_cells, n_cells))
        return _l1_normalize_rows(tr)

    def compute_transition_matrix(self, knn: sparse.spmatrix, x: np.ndarray,
                                  v: np.ndarray, epsilon: float = 0.0,
                                  reverse: bool = False) -> sparse.csr_matrix:
        """Velocity-projected transitions on a kNN graph
        (reference diffusion.py:55-91): p(edge) ~ clip(<v, unit(edge)>, 0)
        / |edge|, row-normalized."""
        knn = knn.tocoo()
        v0, v1 = knn.row, knn.col
        uv = x[v1] - x[v0]
        norms = np.linalg.norm(uv, axis=1)
        uv = uv / norms[:, None]
        scalar_projection = np.einsum("ed,ed->e", v[v0], uv)
        if reverse:
            scalar_projection = -scalar_projection
        scalar_projection = scalar_projection + epsilon
        np.clip(scalar_projection, a_min=0, a_max=None, out=scalar_projection)
        p = scalar_projection * (1.0 / norms)
        tr = sparse.coo_matrix((p, (v0, v1)), shape=knn.shape).tocsr()
        return _l1_normalize_rows(tr)

    def diffuse(self, x: np.ndarray, tr: sparse.spmatrix, n_steps: int = 10,
                mode: str = "path_integral") -> Any:
        """Run the diffusion (reference diffusion.py:93-135).

        path_integral / time_evolution run as a jitted dense scan.
        """
        tr_d = jnp.asarray(tr.toarray() if sparse.issparse(tr) else tr,
                           dtype=jnp.float32)
        x0 = np.asarray(x, dtype=np.float64)
        if mode == "path_integral":
            xt = jnp.asarray(x0 / x0.sum(), dtype=jnp.float32)
            return np.asarray(_path_integral(xt, tr_d, n_steps))[None, :]
        if mode == "time_evolution":
            xt = jnp.asarray(x0 / x0.sum(), dtype=jnp.float32)
            out = _power_steps(xt, tr_d, n_steps)
            return np.asarray(out)[None, :]
        if mode == "map_trajectory":
            xt = x0 / x0.sum()
            result = [int(np.argmax(xt))]
            trn = np.asarray(tr_d)
            for _ in range(n_steps):
                xt = xt @ trn
                result.append(int(np.argmax(xt)))
            return result
        if mode == "frontier":
            xt = x0 / x0.sum()
            result = [int(np.argmax(xt))]
            trn = np.asarray(tr_d)
            for _ in range(n_steps):
                x_next = xt @ trn
                result.append(int(np.argmax((x_next + 1) / (xt + 1))))
                xt = x_next
            return result
        if mode == "trajectory":
            trn = np.asarray(tr_d, dtype=np.float64)
            node = np.random.choice(np.arange(x0.shape[0]), p=x0)
            trajectories = [node]
            for _ in range(n_steps):
                x_next = trn[node].copy()
                s = x_next.sum()
                if s == 0:
                    x_next = np.zeros_like(x_next)
                    x_next[node] = 1.0
                else:
                    x_next = x_next / s
                node = np.random.choice(np.arange(x_next.shape[0]), p=x_next)
                trajectories.append(node)
            return trajectories
        raise NotImplementedError(f"mode {mode} not implemented")
