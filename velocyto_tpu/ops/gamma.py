"""Batched steady-state gamma (degradation-rate) fits, vmapped over genes.

The reference loops genes in Python and calls scipy optimizers per gene
(reference: velocyto/estimation.py:173-366).  Every one of those
optimizations is a (constrained) *quadratic* problem in 1 or 2 variables,
so it has a closed form: we solve each exactly and vmap over genes, which
turns ~20k sequential scipy solves into one fused device program.

Deviation note: scipy's bounded Brent / L-BFGS-B stop at ~1e-5 tolerance
near the true minimizer; our closed forms return the exact constrained
minimizer, so results agree with the reference to optimizer tolerance
(validated in tests against scipy on random data).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _masked_percentile(v, mask, q):
    """np.percentile over v[mask] for a single row."""
    big = jnp.where(mask, v, jnp.inf)
    s = jnp.sort(big)
    cnt = jnp.sum(mask)
    h = (cnt - 1) * (q / 100.0)
    lo = jnp.clip(jnp.floor(h).astype(jnp.int32), 0, v.shape[-1] - 1)
    hi = jnp.clip(jnp.ceil(h).astype(jnp.int32), 0, v.shape[-1] - 1)
    frac = h - jnp.floor(h)
    val = s[lo] * (1.0 - frac) + s[hi] * frac
    return jnp.where(cnt > 0, val, jnp.nan)


def _up_gamma_row(y, x, limit_gamma: bool):
    """The limit_gamma heuristic (reference estimation.py:199-205,228-236):
    cap gamma when unspliced is systematically above spliced."""
    med_y = _masked_percentile(y, jnp.ones_like(y, dtype=bool), 50.0)
    med_x = _masked_percentile(x, jnp.ones_like(x, dtype=bool), 50.0)
    p90_x = _masked_percentile(x, jnp.ones_like(x, dtype=bool), 90.0)
    high_x = x > p90_x
    up = _masked_percentile(y, high_x, 10.0) / _masked_percentile(x, high_x, 50.0)
    up = jnp.maximum(1.5, up)
    capped = jnp.where(med_y > med_x, up, 1.5)
    if limit_gamma:
        return capped
    return jnp.full_like(capped, 20.0)


# ---------------------------------------------------------------------------
# single-gene solvers (vmapped)
# ---------------------------------------------------------------------------

def _slope_nnls_row(y, x):
    """m = argmin_{m>=0} ||x m - y||^2 (reference _fit1_slope,
    estimation.py:173-188: scipy nnls on one column)."""
    any_x = jnp.any(x != 0)
    any_y = jnp.any(y != 0)
    m = jnp.maximum(0.0, jnp.sum(x * y) / jnp.sum(x * x))
    return jnp.where(~any_x, jnp.nan, jnp.where(~any_y, 0.0, m))


def _slope_weighted_row(y, x, w, limit_gamma: bool, lo: float, hi: float):
    """argmin_m sum w (x m - y)^2 over [lo, hi] (or the limit_gamma bounds)
    (reference _fit1_slope_weighted, estimation.py:191-209)."""
    any_x = jnp.any(x != 0)
    any_y = jnp.any(y != 0)
    m_free = jnp.sum(w * x * y) / jnp.sum(w * x * x)
    if limit_gamma:
        up = _up_gamma_row(y, x, True)
        m = jnp.clip(m_free, 1e-8, up)
    else:
        m = jnp.clip(m_free, lo, hi)
    return jnp.where(~any_x, jnp.nan, jnp.where(~any_y, 0.0, m))


def _slope_weighted_offset_row(y, x, w, fixperc_q: bool, limit_gamma: bool):
    """Box-constrained weighted linear fit with intercept
    (reference _fit1_slope_weighted_offset, estimation.py:212-241).

    minimize  sum w (x m + q - y)^2
    s.t.      m in [1e-8, up_gamma],  q in [0, up_q],  up_q = 2 sum(yw)/sum(w)

    Solved exactly: interior stationary point if feasible, else the best of
    the four clipped edge minimizers (the objective is convex quadratic).
    """
    any_x = jnp.any(x != 0)
    any_y = jnp.any(y != 0)

    if fixperc_q:
        p1 = _masked_percentile(x, jnp.ones_like(x, dtype=bool), 1.0)
        m1 = _masked_percentile(y, x <= p1, 50.0)
        m0 = jnp.clip(jnp.sum(w * x * (y - m1)) / jnp.sum(w * x * x), 0.0, 20.0)
        m0 = jnp.where(~any_x, jnp.nan, jnp.where(~any_y, 0.0, m0))
        m1 = jnp.where(~any_x, 0.0, jnp.where(~any_y, 0.0, m1))
        return m0, m1

    mlo = 1e-8
    mhi = _up_gamma_row(y, x, limit_gamma)
    sw = jnp.sum(w)
    swx = jnp.sum(w * x)
    swy = jnp.sum(w * y)
    swxx = jnp.sum(w * x * x)
    swxy = jnp.sum(w * x * y)
    swyy = jnp.sum(w * y * y)
    up_q = 2.0 * swy / sw

    def obj(m, q):
        return (m * m * swxx + q * q * sw + 2 * m * q * swx
                - 2 * m * swxy - 2 * q * swy + swyy)

    det = swxx * sw - swx * swx
    m_int = (swxy * sw - swx * swy) / det
    q_int = (swy * swxx - swx * swxy) / det
    interior_ok = (det > 0) & (m_int >= mlo) & (m_int <= mhi) & \
                  (q_int >= 0) & (q_int <= up_q)

    # edge minimizers (1-D closed forms, clipped to their segment)
    q_at = lambda m: jnp.clip((swy - m * swx) / sw, 0.0, up_q)
    m_at = lambda q: jnp.clip((swxy - q * swx) / swxx, mlo, mhi)
    cand_m = jnp.stack([mlo, mhi, m_at(0.0), m_at(up_q)])
    cand_q = jnp.stack([q_at(mlo), q_at(mhi), 0.0, up_q])
    cand_f = obj(cand_m, cand_q)
    best = jnp.argmin(cand_f)
    m_edge, q_edge = cand_m[best], cand_q[best]

    m = jnp.where(interior_ok, m_int, m_edge)
    q = jnp.where(interior_ok, q_int, q_edge)
    m = jnp.where(~any_x, jnp.nan, jnp.where(~any_y, 0.0, m))
    q = jnp.where(~any_x, 0.0, jnp.where(~any_y, 0.0, q))
    return m, q


def _slope_offset_row(y, x, fixperc_q: bool):
    """OLS with intercept (reference _fit1_slope_offset,
    estimation.py:244-264; leastsq on a linear residual == OLS)."""
    any_x = jnp.any(x != 0)
    any_y = jnp.any(y != 0)
    if fixperc_q:
        p1 = _masked_percentile(x, jnp.ones_like(x, dtype=bool), 1.0)
        m1 = _masked_percentile(y, x <= p1, 50.0)
        m0 = jnp.clip(jnp.sum(x * (y - m1)) / jnp.sum(x * x), 0.0, 20.0)
        m0 = jnp.where(~any_x, jnp.nan, jnp.where(~any_y, 0.0, m0))
        m1 = jnp.where(~any_x, 0.0, jnp.where(~any_y, 0.0, m1))
        return m0, m1
    n = x.shape[-1]
    sx, sy = jnp.sum(x), jnp.sum(y)
    sxx, sxy = jnp.sum(x * x), jnp.sum(x * y)
    det = n * sxx - sx * sx
    m = (n * sxy - sx * sy) / det
    q = (sy - m * sx) / n
    m = jnp.where(~any_x, jnp.nan, jnp.where(~any_y, 0.0, m))
    q = jnp.where(~any_x, 0.0, jnp.where(~any_y, 0.0, q))
    return m, q


def _r2_rows(Y, X, m, q):
    """Unweighted coefficient of determination of the (weighted) fit
    (reference estimation.py:323-331,354-363)."""
    ss_res = jnp.sum((m[:, None] * X + q[:, None] - Y) ** 2, axis=1)
    ss_tot = jnp.sum((Y - jnp.mean(Y, axis=1, keepdims=True)) ** 2, axis=1)
    r2 = 1.0 - ss_res / ss_tot
    return jnp.where(jnp.isfinite(r2), r2, -1e16)


# ---------------------------------------------------------------------------
# public batched API (reference fit_slope*, estimation.py:267-366)
# ---------------------------------------------------------------------------

@jax.jit
def _fit_slope_impl(Y, X):
    return jax.vmap(_slope_nnls_row)(Y, X)


def fit_slope(Y: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Y, X: (genes, cells). Returns per-gene slope, float32."""
    out = _fit_slope_impl(jnp.asarray(Y, jnp.float32), jnp.asarray(X, jnp.float32))
    return np.array(out, dtype=np.float32)


@functools.partial(jax.jit, static_argnames=("limit_gamma", "lo", "hi"))
def _fit_slope_weighted_impl(Y, X, W, limit_gamma, lo, hi):
    m = jax.vmap(lambda y, x, w: _slope_weighted_row(y, x, w, limit_gamma, lo, hi))(Y, X, W)
    r2 = _r2_rows(Y, X, m, jnp.zeros_like(m))
    return m, r2


def fit_slope_weighted(Y, X, W, return_R2: bool = False,
                       limit_gamma: bool = False,
                       bounds: Tuple[float, float] = (0, 20)):
    m, r2 = _fit_slope_weighted_impl(
        jnp.asarray(Y, jnp.float32), jnp.asarray(X, jnp.float32),
        jnp.asarray(W, jnp.float32), limit_gamma,
        float(bounds[0]), float(bounds[1]))
    m = np.array(m, dtype=np.float32)
    if return_R2:
        return m, np.array(r2, dtype=np.float32)
    return m


@functools.partial(jax.jit, static_argnames=("fixperc_q", "limit_gamma"))
def _fit_slope_weighted_offset_impl(Y, X, W, fixperc_q, limit_gamma):
    m, q = jax.vmap(lambda y, x, w: _slope_weighted_offset_row(
        y, x, w, fixperc_q, limit_gamma))(Y, X, W)
    r2 = _r2_rows(Y, X, m, q)
    return m, q, r2


def fit_slope_weighted_offset(Y, X, W, fixperc_q: bool = False,
                              return_R2: bool = True,
                              limit_gamma: bool = False):
    m, q, r2 = _fit_slope_weighted_offset_impl(
        jnp.asarray(Y, jnp.float32), jnp.asarray(X, jnp.float32),
        jnp.asarray(W, jnp.float32), fixperc_q, limit_gamma)
    m = np.array(m, dtype=np.float32)
    q = np.array(q, dtype=np.float32)
    if return_R2:
        return m, q, np.array(r2, dtype=np.float32)
    return m, q


@functools.partial(jax.jit, static_argnames=("fixperc_q",))
def _fit_slope_offset_impl(Y, X, fixperc_q):
    return jax.vmap(lambda y, x: _slope_offset_row(y, x, fixperc_q))(Y, X)


def fit_slope_offset(Y, X, fixperc_q: bool = False):
    m, q = _fit_slope_offset_impl(
        jnp.asarray(Y, jnp.float32), jnp.asarray(X, jnp.float32), fixperc_q)
    return np.array(m, dtype=np.float32), np.array(q, dtype=np.float32)


# The fit_gammas weighting schemes (reference analysis.py:1139-1191) as
# fused device programs over the (genes, cells) matrices.  Replaces the
# host numpy percentile passes; boundary elements may differ from the
# host f64 masks by f32 rounding at the percentile thresholds (each
# flips one 0/1 weight among N cells).


def _row_percentiles(M, qs):
    """np.percentile(M, qs, axis=1) (linear interpolation) with static
    qs: ONE row sort serves every requested percentile via static
    column slicing, the minimal program for a static set of
    percentiles."""
    s = jnp.sort(M, axis=1)
    n = M.shape[1]
    out = []
    for q in qs:
        h = (n - 1) * (float(q) / 100.0)
        lo_i = int(np.floor(h))
        hi_i = int(np.ceil(h))
        frac = jnp.asarray(h - lo_i, M.dtype)
        out.append(s[:, lo_i] * (1 - frac) + s[:, hi_i] * frac)
    return out


@functools.partial(jax.jit,
                   static_argnames=("scheme", "lo", "hi", "wpow"))
def _fit_weights_tmp_impl(tmpS, tmpU, scheme: str, lo, hi, wpow):
    if scheme in ("sum", "prod"):
        (p99S,) = _row_percentiles(tmpS, (99.0,))
        (p99U,) = _row_percentiles(tmpU, (99.0,))
        if scheme == "sum":
            return tmpS / p99S[:, None] + tmpU / p99U[:, None]
        return (tmpS / p99S[:, None]) * (tmpU / p99U[:, None])
    down, up = _row_percentiles(tmpS, (lo, hi))
    if scheme == "maxmin_weighted":
        Srange = jnp.clip(tmpS, down[:, None], up[:, None])
        Srange = Srange - Srange.min(1)[:, None]
        Srange = Srange / Srange.max(1)[:, None]
        return 0.5 * (Srange ** wpow + (1 - Srange) ** wpow)
    return ((tmpS <= down[:, None])                         # "maxmin"
            | (tmpS >= up[:, None])).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("scheme", "lo", "hi"))
def _fit_weights_xs_impl(Sx, Ux, scheme: str, lo, hi):
    # maxmin_diag / maxmin_double operate on the unsized imputed data
    def _denom(M):
        (d,) = _row_percentiles(M, (99.9,))
        repl = jnp.maximum(jnp.max(M, axis=1), 0.001)
        return jnp.where(d == 0, repl, d)

    X = Sx / _denom(Sx)[:, None] + Ux / _denom(Ux)[:, None]
    down, up = _row_percentiles(X, (lo, hi))
    W = ((X <= down[:, None]) | (X >= up[:, None])).astype(jnp.float32)
    if scheme == "maxmin_double":
        down, up = _row_percentiles(Sx, (lo, hi))
        W = W + ((Sx <= down[:, None])
                 | (Sx >= up[:, None])).astype(jnp.float32)
    return W


def compute_fit_weights(scheme: str, tmpS, tmpU, Sx, Ux,
                        maxmin_perc=(2.0, 98.0),
                        maxmin_weighted_pow: float = 15.0):
    """Device fit_gammas weights; inputs are (genes, cells) f32 device
    (or host) arrays, output stays on device.  Only the matrices the
    scheme actually reads are uploaded."""
    lo, hi = float(maxmin_perc[0]), float(maxmin_perc[1])
    if scheme in ("sum", "prod", "maxmin_weighted", "maxmin"):
        return _fit_weights_tmp_impl(
            jnp.asarray(tmpS, jnp.float32), jnp.asarray(tmpU, jnp.float32),
            scheme, lo, hi, float(maxmin_weighted_pow))
    return _fit_weights_xs_impl(
        jnp.asarray(Sx, jnp.float32), jnp.asarray(Ux, jnp.float32),
        scheme, lo, hi)


def clusters_stats(U: np.ndarray, S: np.ndarray, clusters_uid: np.ndarray,
                   cluster_ix: np.ndarray, size_limit: int = 40
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cluster averages with a small-cluster fallback to the global
    average (reference estimation.py:369-389)."""
    U_avgs = np.zeros((S.shape[0], len(clusters_uid)))
    S_avgs = np.zeros((S.shape[0], len(clusters_uid)))
    for i, _uid in enumerate(clusters_uid):
        cluster_filter = cluster_ix == i
        n_cells = np.sum(cluster_filter)
        if n_cells > size_limit:
            U_avgs[:, i] = U[:, cluster_filter].mean(1)
            S_avgs[:, i] = S[:, cluster_filter].mean(1)
        else:
            U_avgs[:, i] = U.mean(1)
            S_avgs[:, i] = S.mean(1)
    return U_avgs, S_avgs
