"""The flagship RNA-velocity model as one fused, jittable device program.

This is the whole estimation hot path -- kNN smoothing, steady-state
gamma fit, velocity extrapolation, neighbor-sampled colDeltaCor and the
embedding projection -- expressed as a single pure function over
fixed-shape arrays, so XLA fuses it end-to-end and it shards over a
(cells, genes) mesh with collectives inserted automatically.

Mathematical semantics follow the reference pipeline
(velocyto/analysis.py:933-1739 happy path with default arguments:
knn_imputation -> fit_gammas(weights="maxmin") -> predict_U ->
calculate_velocity -> calculate_shift(constant_velocity) ->
extrapolate_cell_at_t -> estimate_transition_prob(transform="sqrt") ->
calculate_embedding_shift), restricted to the compact sampled-neighbor
representation throughout.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..parallel.mesh import CELLS, GENES
from ..ops.coldeltacor import _apply_transform, _corr_from_moments, _SQRT
from ..ops.gamma import _slope_weighted_offset_row


class VelocityOutputs(NamedTuple):
    gammas: jax.Array            # (G,)
    q: jax.Array                 # (G,)
    velocity: jax.Array          # (G, N)
    corr: jax.Array              # (N, nn) sampled-neighbor correlations
    transition_prob: jax.Array   # (N, nn)
    delta_embedding: jax.Array   # (N, D)


def velocity_step(S_sz: jax.Array, U_sz: jax.Array,
                  nbr_idx: jax.Array, nbr_w: jax.Array,
                  embedding: jax.Array, sample_ixs: jax.Array,
                  sigma_corr: float = 0.05,
                  psc: float = 1e-10) -> VelocityOutputs:
    """One full velocity-estimation step.

    S_sz, U_sz:   (G, N) size-normalized spliced/unspliced
    nbr_idx/w:    (N, K) smoothing neighbors + weights (row-stochastic)
    embedding:    (N, D) low-dim embedding
    sample_ixs:   (N, nn) sampled transition-candidate cells
    """
    g, n = S_sz.shape

    # --- kNN smoothing (scatter-to-dense + matmul; one kernel with
    #     ops.knn_device._smooth_rows_impl) ------------------------------
    from ..ops.knn_device import _smooth_rows_impl

    def smooth(M):
        return _smooth_rows_impl(M.T, nbr_idx, nbr_w).T    # (G, N)

    Sx = smooth(S_sz)
    Ux = smooth(U_sz)

    # --- steady-state gamma fit (maxmin extreme-quantile weights, with
    #     offset; the exact box-QP solver shared with ops.gamma /
    #     VelocytoLoom.fit_gammas(weights="maxmin", fit_offset=True)) ----
    from ..ops.gamma import _row_percentiles
    down, up = _row_percentiles(Sx, (2.0, 98.0))
    W = ((Sx <= down[:, None]) | (Sx >= up[:, None])).astype(jnp.float32)

    gammas, q = jax.vmap(lambda y, x, w: _slope_weighted_offset_row(
        y, x, w, fixperc_q=False, limit_gamma=False))(Ux, Sx, W)
    gammas = jnp.where(jnp.isfinite(gammas), gammas, 0.0)
    q = jnp.where(jnp.isfinite(q), q, 0.0)

    # --- velocity + extrapolation -------------------------------------
    velocity = Ux - (gammas[:, None] * Sx + q[:, None])
    delta_S = velocity                                # constant_velocity
    hi_dim = Sx
    hi_dim_t = hi_dim + delta_S                       # used_delta_t = 1

    # --- sampled-neighbor colDeltaCor (sqrt transform) ----------------
    delta = hi_dim_t - hi_dim
    d_rows = (jnp.sqrt(jnp.abs(delta) + psc) * jnp.sign(delta)).T  # (N, G)
    e_rows = hi_dim.T                                               # (N, G)
    e_nb = e_rows[sample_ixs]                          # (N, nn, G)
    a = _apply_transform(e_nb - e_rows[:, None, :], _SQRT, psc, partial=True)
    s1 = jnp.sum(a, axis=-1)
    s2 = jnp.sum(a * a, axis=-1)
    s3 = jnp.einsum("bng,bg->bn", a, d_rows,
                    precision=jax.lax.Precision.HIGHEST)
    sb1 = jnp.sum(d_rows, axis=-1)[:, None]
    sb2 = jnp.sum(d_rows * d_rows, axis=-1)[:, None]
    corr = _corr_from_moments(s1, s2, s3, sb1, sb2, float(g))
    corr = jnp.where(jnp.isfinite(corr), corr, 0.0)
    corr = jnp.where(sample_ixs == jnp.arange(n)[:, None], 0.0, corr)

    # --- transition probabilities + embedding shift -------------------
    p = jnp.exp(corr / sigma_corr)
    p = p / jnp.sum(p, axis=1, keepdims=True)
    diff = embedding[sample_ixs] - embedding[:, None, :]   # (N, nn, D)
    nrm = jnp.linalg.norm(diff, axis=-1, keepdims=True)
    unit = jnp.where(nrm > 0, diff / jnp.where(nrm == 0, 1.0, nrm), 0.0)
    delta_embedding = jnp.einsum("nk,nkd->nd", p, unit,
                                 precision=jax.lax.Precision.HIGHEST) \
        - jnp.mean(unit, axis=1)

    return VelocityOutputs(gammas, q, velocity, corr, p, delta_embedding)


velocity_step_jit = jax.jit(velocity_step, static_argnames=("sigma_corr",
                                                            "psc"))


def make_sharded_velocity_step(mesh: Mesh):
    """jit velocity_step with NamedShardings over a (cells, genes) mesh.

    Sharding layout (the framework's parallelism strategy):
      - gene-major matrices (G, N): genes on the GENES axis, cells on CELLS
        (both model- and data-parallel; XLA inserts psums for the
        cells-axis reductions of the gamma fit and gene-axis reductions of
        the correlation moments)
      - per-cell tables (N, K): cells on CELLS
      - per-gene vectors (G,): GENES
    """
    gn = NamedSharding(mesh, P(GENES, CELLS))
    cells_rows = NamedSharding(mesh, P(CELLS, None))
    gvec = NamedSharding(mesh, P(GENES))
    return jax.jit(
        velocity_step,
        static_argnames=("sigma_corr", "psc"),
        in_shardings=(gn, gn, cells_rows, cells_rows, cells_rows, cells_rows),
        out_shardings=VelocityOutputs(
            gvec, gvec, gn, cells_rows, cells_rows, cells_rows),
    )


def example_inputs(g: int = 256, n: int = 512, k: int = 8, nn: int = 32,
                   d: int = 2, seed: int = 0):
    """Small random-but-well-conditioned inputs for compile checks."""
    rng = np.random.RandomState(seed)
    S = rng.gamma(2.0, 2.0, size=(g, n)).astype(np.float32)
    U = (0.3 * S + 0.1 * rng.rand(g, n)).astype(np.float32)
    nbr_idx = np.stack([rng.choice(n, k, replace=False)
                        for _ in range(n)]).astype(np.int32)
    nbr_w = np.full((n, k), 1.0 / k, dtype=np.float32)
    emb = rng.randn(n, d).astype(np.float32)
    sample_ixs = np.stack([rng.choice(n, nn, replace=False)
                           for _ in range(n)]).astype(np.int32)
    return (jnp.asarray(S), jnp.asarray(U), jnp.asarray(nbr_idx),
            jnp.asarray(nbr_w), jnp.asarray(emb), jnp.asarray(sample_ixs))
