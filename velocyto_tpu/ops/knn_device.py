"""Fully device-resident balanced-kNN: search, exact re-score, greedy
balancing and smoothing-weight construction without any large
host<->device transfer.

Motivation: the host-side balanced-kNN path (ops/knn.py) must pull the
(N, sight) candidate-index matrix to the host for the exact f64 re-score
and the greedy balancing loop -- ~105 MB at the reference's 20k-cell
operating point (reference doc/tutorial/analysis.rst:109: k=500,
b_sight=3000).  This module keeps the whole chain on device:

  candidate pass (f32 blocked matmul distances, ops/knn.py semantics)
    -> exact re-score in f64 (diff-form, elementwise, native IEEE f64)
       [replaces the host numpy re-score]
    -> lexicographic (distance, index) ordering  [sklearn tie-breaks]
    -> greedy degree-capped balancing as a speculative batched
       while_loop (reference velocyto/neighbors.py:11-140 -- decisions
       are pure integer logic, so the result is bit-equal to the numba
       loop given the same candidate ordering; see _balance_scan_impl)
    -> compact (N, K) neighbor-index/weight arrays for the smoothing
       convolution (reference velocyto/analysis.py:1006-1016)

Only O(N) or O(N * k)-sized *results* ever need to cross the link, and
only lazily (analysis.VelocytoLoom materializes `.knn` on first access).

The f64 device arithmetic needs jax_explicit_x64_dtypes=allow (set at
package import): explicitly-requested 64-bit dtypes are honored without
flipping global x64 promotion semantics.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .knn import _candidate_plan, _knn_search_impl


class KnnGraphDev(NamedTuple):
    """Device-resident kNN graph state.

    For the balanced graph: ``idx``/``dist`` are the (N, k+1) balanced
    rows (slot 0 = self, -1 = unset) in the reference's dsi_new/dist_new
    layout.  For the plain graph: (N, k) non-self neighbors, ascending.
    ``indeg`` is the in-degree vector (balanced only).
    """
    idx: jax.Array          # int32
    dist: jax.Array         # float64
    indeg: Optional[jax.Array]
    n: int
    balanced: bool


# ---------------------------------------------------------------------------
# exact f64 re-score + ordering, on device
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("block",))
def _rescore_f64_impl(x64: jax.Array, idx: jax.Array, block: int) -> jax.Array:
    """Exact f64 squared distances of gathered candidates, blocked.

    Diff-form (sum((x_i - x_j)^2)) rather than GEMM-form: the diff-form
    is exactly 0 for duplicate points, which preserves sklearn-style tie
    groups, and carries no cancellation error from the norm expansion.
    """
    n, d = x64.shape
    k = idx.shape[1]
    n_pad = ((n + block - 1) // block) * block
    idx_p = jnp.pad(idx, ((0, n_pad - n), (0, 0)))
    x_pad = jnp.pad(x64, ((0, n_pad - n), (0, 0)))

    def body(r0):
        ib = jax.lax.dynamic_slice(idx_p, (r0, 0), (block, k))
        rows = jax.lax.dynamic_slice(x_pad, (r0, 0), (block, d))
        diff = x64[ib] - rows[:, None, :]
        return jnp.sum(diff * diff, axis=-1)

    out = jax.lax.map(body, jnp.arange(0, n_pad, block))
    return out.reshape(n_pad, k)[:n]


@functools.partial(jax.jit, static_argnames=("k",))
def _reorder_truncate_impl(d2: jax.Array, idx: jax.Array, k: int
                           ) -> Tuple[jax.Array, jax.Array]:
    """Lexicographic (distance, index) ascending order, truncated to k --
    the same tie-breaking as sklearn exact brute force (and as the host
    _exact_rescore_topk).  One two-key variadic sort instead of two
    argsorts + four take_along_axis gathers."""
    dd, ii = jax.lax.sort((d2, idx), num_keys=2)
    return dd[:, :k], ii[:, :k]


def knn_search_dev(data: np.ndarray, k: int, metric: str = "euclidean",
                   block: int = 512, mesh=None
                   ) -> Tuple[jax.Array, jax.Array]:
    """All-pairs kNN (self included first), entirely on device.

    Returns (dist (N, k) f64, idx (N, k) i32) device arrays, ordered
    exactly like ops.knn.knn_search (f64 re-score, sklearn tie-breaks).
    Upload: the (N, D) data.  Download: nothing.
    """
    n = data.shape[0]
    k = min(k, n)
    x64h = np.asarray(data, dtype=np.float64)
    if metric == "correlation":
        x64h = x64h - x64h.mean(axis=1, keepdims=True)
        x64h = x64h / np.linalg.norm(x64h, axis=1, keepdims=True)
    x64 = jnp.asarray(x64h, dtype=jnp.float64)

    k2, blk, use_sort = _candidate_plan(n, k, block)
    if mesh is not None:
        from .knn import make_knn_search_sharded, _normalize_for_metric
        from ..parallel.mesh import CELLS
        shards = mesh.shape[CELLS]
        n_pad = ((n + shards - 1) // shards) * shards
        x32 = _normalize_for_metric(jnp.asarray(data, dtype=jnp.float32),
                                    metric)
        rows_p = jnp.pad(x32, ((0, n_pad - n), (0, 0)))
        sq_p = jnp.sum(rows_p * rows_p, axis=1)
        fn = make_knn_search_sharded(mesh, k2, blk, metric, use_sort)
        _d2c, cand = fn(x32, rows_p, sq_p)
        cand = cand[:n]
    else:
        _dc, cand = _knn_search_impl(jnp.asarray(data, dtype=jnp.float32),
                                     k2, blk, metric, use_sort)

    # bound the (block, k2, D) f64 gather scratch to ~256 MB
    rb = max(8, min(256, (1 << 25) // max(1, k2 * x64.shape[1])))
    d2 = _rescore_f64_impl(x64, cand, rb)
    d2, idx = _reorder_truncate_impl(d2, cand, k)
    if metric == "correlation":
        dist = d2 / 2.0
    else:
        dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    return dist, idx


# ---------------------------------------------------------------------------
# greedy balancing as a scan (reference velocyto/neighbors.py:11-140)
# ---------------------------------------------------------------------------

def _balance_plan(n: int, sight: int, k: int) -> Tuple[int, int]:
    """(B, T) for the speculative batched balance: window size B and
    candidate-depth truncation T.

    T bounds how deep into each sight row the batched path looks.  The
    greedy loop stops at the k-th acceptance, so a row only needs its
    first k + (#rejections) candidates; measured at the bench operating
    shape (k=500, sight=3000, maxl=1500; 12k-cell anisotropic-gaussian
    instrumentation run) the max examined depth was 660 with the 99.9th
    percentile at 640.  Deeper rows are detected exactly and redone at
    full width, so T only affects speed, never results.
    B trades batch parallelism against re-speculation waste: in the
    saturated phase the window advances ~one cap-crossing gap (~13 rows
    measured) per iteration regardless of B.
    """
    t = min(sight, ((k + 1 + max(192, k // 2) + 127) // 128) * 128)
    return 32, t


@functools.partial(jax.jit, static_argnames=("maxl", "k", "has_constraint"))
def _balance_scan_impl(dsi: jax.Array, dist: jax.Array, lsi: jax.Array,
                       constraint: jax.Array, maxl: int, k: int,
                       has_constraint: bool
                       ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Degree-capped greedy balancing, bit-equal to the reference numba
    loop (velocyto/neighbors.py:11-140) for the same candidate ordering.

    The loop is sequential by construction (each node's acceptance set
    depends on the in-degree vector l mutated by every earlier node),
    but the dependency is narrow: decisions change ONLY when a
    candidate's in-degree crosses the maxl cap mid-window.  So the scan
    speculates: it evaluates a window of B nodes in parallel against the
    window-entry l, detects every node m whose cap could bind inside the
    window (l[m] + speculative acceptances > maxl), and commits exactly
    the prefix of rows that provably saw no such m in their examined
    region -- those decisions are identical to sequential execution by
    induction (the first divergent row must have examined a flagged m).
    The first affected row is then redone alone at full sight width
    against the committed l, and the window restarts after it.  Rows
    whose k-th acceptance lies deeper than the T-column truncation are
    flagged the same way and fall into the same full-width redo (this
    also covers the self-fill case, which needs the whole row).

    All decisions are integer comparisons, so the result is exact on
    every backend and bit-equal to the host loop; only the iteration
    count is data-dependent (N/B + one extra iteration per cap-crossing
    or deep row).
    """
    n, sight = dsi.shape
    bsz, t = _balance_plan(n, sight, k)
    bsz = min(bsz, max(1, n))
    npad = n + 1                      # row n = dummy sink
    # dummy row: el = n, candidates = n (self) -> accepts nothing
    dsi_p = jnp.concatenate([dsi, jnp.full((1, sight), n, dsi.dtype)])
    lsi_p = jnp.concatenate(
        [lsi.astype(jnp.int32), jnp.full((bsz,), n, jnp.int32)])
    cst_p = jnp.concatenate([constraint.astype(jnp.int32),
                             jnp.zeros((1,), jnp.int32)]) \
        if has_constraint else jnp.zeros((npad,), jnp.int32)
    dsi_t = dsi_p[:, :t]              # contiguous truncated view
    br = jnp.arange(bsz, dtype=jnp.int32)
    slots = jnp.arange(k + 1)
    # the loop carries only 32-bit slot->row-POSITION codes; indices and
    # f64 distances are decoded in one vectorized gather afterwards.
    # codes: >=0 slot holds row position p; -1 empty (-1 idx, 0 dist);
    # -2 self-fill (el idx, drow[0] dist); -3 self slot (el idx, 0 dist)
    iota_t = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (bsz, t))
    iota_s = jnp.arange(sight, dtype=jnp.int32)

    def redo_row(l, el, do, out_p):
        """One node at full sight width against the live l (the exact
        sequential step, incl. self-slot and self-fill)."""
        row = dsi_p[el]
        l_row = l[row]
        valid = (row != el) & (l_row < maxl)
        if has_constraint:
            valid &= cst_p[row] == cst_p[el]
        cs = jnp.cumsum(valid.astype(jnp.int32))
        accept = valid & (cs <= k) & do
        p_final = jnp.minimum(cs[-1], k)
        acc_before = jnp.minimum(cs - valid.astype(jnp.int32), k)
        examined = acc_before < k
        self_found = jnp.any((row == el) & examined)
        targets = jnp.where(accept, cs, k + 1)        # k+1 drops
        row_p = jnp.full((k + 1,), -1, jnp.int32).at[targets].set(
            iota_s, mode="drop")
        row_p = row_p.at[0].set(jnp.where(self_found, -3, -1))
        fill = slots > p_final                         # slot 0 never fills
        row_p = jnp.where(fill, -2, row_p)
        l = l.at[row].add(accept.astype(l.dtype))
        wr = jnp.where(do, el, npad)                   # npad drops
        return l, out_p.at[wr].set(row_p, mode="drop")

    def cond(st):
        return st[0] < n

    def body(st):
        pos, l, out_p = st
        win = jax.lax.dynamic_slice(lsi_p, (pos,), (bsz,))    # (B,)
        real = win < n
        rows = dsi_t[win]                                     # (B, T)
        l_row = l[rows]
        valid = (rows != win[:, None]) & (l_row < maxl)
        if has_constraint:
            valid &= cst_p[rows] == cst_p[win][:, None]
        cs = jnp.cumsum(valid.astype(jnp.int32), axis=1)
        accept = valid & (cs <= k)
        deep = (cs[:, -1] < k) & real
        # speculative in-degree increments over the whole window: any m
        # whose cap could bind mid-window is flagged, and with it every
        # row that examines it
        inc = jnp.zeros((npad,), jnp.int32).at[rows].add(
            accept.astype(jnp.int32))
        bad = (l < maxl) & (l + inc > maxl)
        acc_before = cs - valid.astype(jnp.int32)
        examined = acc_before < k
        row_bad = (jnp.any(bad[rows] & examined, axis=1) & real) | deep
        jstar = jnp.where(jnp.any(row_bad),
                          jnp.argmax(row_bad).astype(jnp.int32),
                          jnp.int32(bsz))
        commit = br < jstar
        # committed rows reached k accepts within T, so their output is
        # slot0 + the k accepted entries in acceptance order: compact
        # via a keyed sort (accepted entries carry their distinct cs
        # rank, the rest sort past the k-slice)
        key = jnp.where(accept, cs, t + 1)
        _, srt_p = jax.lax.sort((key, iota_t), num_keys=1)
        self_found = jnp.any((rows == win[:, None]) & examined, axis=1)
        rows_p = jnp.concatenate(
            [jnp.where(self_found, -3, -1)[:, None], srt_p[:, :k]], axis=1)
        wr = jnp.where(commit, win, npad)
        out_p = out_p.at[wr].set(rows_p, mode="drop")
        l = l.at[rows].add(
            (accept & commit[:, None]).astype(jnp.int32))
        # redo the first affected row alone, against the committed l
        do = jstar < bsz
        el_j = win[jnp.minimum(jstar, bsz - 1)]
        l, out_p = redo_row(l, el_j, do, out_p)
        pos = pos + jnp.where(do, jstar + 1, jnp.int32(bsz))
        return pos, l, out_p

    st0 = (jnp.int32(0), jnp.zeros((npad,), jnp.int32),
           jnp.full((npad, k + 1), -1, jnp.int32))
    _, l, out_p = jax.lax.while_loop(cond, body, st0)
    out_p = out_p[:n]
    # decode position codes -> (dist_new, dsi_new) in one pass
    el_col = jnp.arange(n, dtype=jnp.int32)[:, None]
    gathered_i = jnp.take_along_axis(dsi, jnp.maximum(out_p, 0), axis=1)
    gathered_d = jnp.take_along_axis(dist, jnp.maximum(out_p, 0), axis=1)
    dsi_new = jnp.where(out_p >= 0, gathered_i,
                        jnp.where(out_p <= -2, el_col, -1))
    dist_new = jnp.where(out_p >= 0, gathered_d,
                         jnp.where(out_p == -2, dist[:, :1],
                                   jnp.zeros((), dist.dtype)))
    return dist_new, dsi_new, l[:n]


@jax.jit
def _hub_order_impl(dsi: jax.Array) -> jax.Array:
    """Visit order: descending in-degree of the raw candidate graph,
    ties broken like np.argsort(l, kind='mergesort')[::-1] (stable
    ascending, reversed -> larger index first among equals)."""
    n = dsi.shape[0]
    counts = jnp.zeros((n,), jnp.int32).at[dsi.ravel()].add(1)
    return jnp.argsort(counts, stable=True)[::-1]


def balance_knn_dev(dsi: jax.Array, dist: jax.Array, maxl: int, k: int,
                    constraint: Optional[np.ndarray] = None
                    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Device equivalent of ops.knn.knn_balance: computes the hub order
    and runs the greedy scan.  Returns (dist_new, dsi_new, l) device
    arrays in the reference layout."""
    lsi = _hub_order_impl(dsi)
    has_c = constraint is not None
    cst = (jnp.asarray(np.asarray(constraint), jnp.int32) if has_c
           else jnp.zeros((dsi.shape[0],), jnp.int32))
    return _balance_scan_impl(dsi, dist, lsi, cst, int(maxl), int(k), has_c)


# ---------------------------------------------------------------------------
# graph construction drivers
# ---------------------------------------------------------------------------

def balanced_knn_graph_dev(space: np.ndarray, k: int, sight_k: int,
                           maxl: int, metric: str = "euclidean",
                           constraint: Optional[np.ndarray] = None,
                           mesh=None) -> KnnGraphDev:
    """Balanced kNN graph fully on device (BalancedKNN.kneighbors_graph
    semantics, reference velocyto/neighbors.py:226-322)."""
    n = space.shape[0]
    kk = min(sight_k + 1, n)
    dist, dsi = knn_search_dev(space, kk, metric=metric, mesh=mesh)
    dist_new, dsi_new, l = balance_knn_dev(dsi, dist, maxl=maxl, k=k,
                                           constraint=constraint)
    return KnnGraphDev(idx=dsi_new, dist=dist_new, indeg=l, n=n,
                       balanced=True)


def knn_graph_dev(space: np.ndarray, k: int, metric: str = "euclidean",
                  mesh=None) -> KnnGraphDev:
    """Plain kNN graph excluding self (ops.knn.knn_distance_matrix
    semantics), on device."""
    n = space.shape[0]
    kk = min(k + 1, n)
    dist, idx = knn_search_dev(space, kk, metric=metric, mesh=mesh)
    return KnnGraphDev(idx=idx[:, 1:], dist=dist[:, 1:], indeg=None, n=n,
                       balanced=False)


# ---------------------------------------------------------------------------
# smoothing weights (reference velocyto/analysis.py:1001-1016)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=())
def _compact_weights_impl(idx: jax.Array, dist: jax.Array, diag: jax.Array
                          ) -> Tuple[jax.Array, jax.Array]:
    """Row-normalized smoothing weights in compact (N, K+1) form.

    Replicates connectivity = (knn > 0); setdiag(diag);
    w = row-normalize(connectivity) (reference analysis.py:1001-1005 +
    neighbors.py:385-390): zero-distance entries (self slot, self-fill,
    exact duplicates) drop out of the connectivity exactly as they do in
    the reference's csr construction, and the diagonal carries `diag`.
    """
    n, kw = idx.shape
    present = (dist > 0).astype(jnp.float32)
    self_col = jnp.arange(n, dtype=jnp.int32)[:, None]
    nbr_idx = jnp.concatenate([self_col, idx.astype(jnp.int32)], axis=1)
    vals = jnp.concatenate(
        [jnp.full((n, 1), diag, jnp.float32), present], axis=1)
    rowsum = jnp.sum(vals, axis=1, keepdims=True)
    w = vals / rowsum
    # csr-identical ascending-index order per row so the smoothing
    # einsum accumulates in the same sequence as the sparse host path
    # (zero-weight entries contribute exact zeros wherever they land)
    order = jnp.argsort(jnp.where(w > 0, nbr_idx, jnp.int32(2**31 - 1)),
                        axis=1, stable=True)
    return (jnp.take_along_axis(nbr_idx, order, axis=1),
            jnp.take_along_axis(w, order, axis=1))


def compact_weights_dev(g: KnnGraphDev, diag: float = 1.0
                        ) -> Tuple[jax.Array, jax.Array]:
    """(nbr_idx, nbr_w) (N, K+1) device arrays; nbr_w rows sum to 1."""
    return _compact_weights_impl(g.idx, g.dist, jnp.float32(diag))


@functools.partial(jax.jit, static_argnames=("block",))
def _smooth_rows_impl(data_rows: jax.Array, nbr_idx: jax.Array,
                      nbr_w: jax.Array, block: int = 2048) -> jax.Array:
    """out[i] = sum_k w[i,k] * data_rows[idx[i,k]] -- the smoothing
    convolution over cells-as-rows.

    Computed as blocked scatter-to-dense + matmul: each row block
    scatters its (B, K) weights into a dense (B, N) slab and one matmul
    contracts it with the data.  A K-wide gather+einsum would move
    N*K*G*4 bytes (~80 GB at the 20k x 500-neighbor x 2k-gene operating
    point); the dense slab costs B*N scratch and turns the whole
    contraction into one matmul per block.
    """
    n, gdim = data_rows.shape
    kk = nbr_idx.shape[1]
    # clamp so the (block, N) slab stays ~256 MB at any cell count
    block = min(block, max(8, (1 << 26) // max(1, n)), max(8, n))
    n_pad = ((n + block - 1) // block) * block
    idx_p = jnp.pad(nbr_idx, ((0, n_pad - n), (0, 0)))
    w_p = jnp.pad(nbr_w, ((0, n_pad - n), (0, 0)))
    rows_b = jnp.arange(block, dtype=jnp.int32)[:, None]

    def body(r0):
        ib = jax.lax.dynamic_slice(idx_p, (r0, 0), (block, kk))
        wb = jax.lax.dynamic_slice(w_p, (r0, 0), (block, kk))
        slab = jnp.zeros((block, n), jnp.float32).at[
            rows_b, ib].add(wb, mode="drop")
        return jnp.matmul(slab, data_rows,
                          precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.map(body, jnp.arange(0, n_pad, block))
    return out.reshape(n_pad, gdim)[:n]


def smooth_dev(data_cols_dev: jax.Array, nbr_idx: jax.Array,
               nbr_w: jax.Array) -> jax.Array:
    """Smooth a (G, N) device matrix over cells: returns (G, N)."""
    out_rows = _smooth_rows_impl(data_cols_dev.T, nbr_idx, nbr_w)
    return out_rows.T


def smooth_dev_multi(data_cols_list, nbr_idx: jax.Array,
                     nbr_w: jax.Array):
    """Smooth several (G, N) matrices in ONE convolution pass.

    The convolution streams the (B, N) weight slab through HBM; that
    cost is per PASS, not per matrix, so one matmul against the
    gene-concatenated data amortizes it across all inputs (Sx+Ux drop
    from 2 slabs to 1)."""
    gs = [d.shape[0] for d in data_cols_list]
    stacked = jnp.concatenate([d.T for d in data_cols_list], axis=1)
    out = _smooth_rows_impl(stacked, nbr_idx, nbr_w)
    outs = []
    off = 0
    for g in gs:
        outs.append(out[:, off:off + g].T)
        off += g
    return outs


# ---------------------------------------------------------------------------
# host materialization (lazy .knn / .knn_smoothing_w views)
# ---------------------------------------------------------------------------

def graph_to_csr(g: KnnGraphDev):
    """Materialize the reference csr form of the graph on host
    (BalancedKNN.kneighbors_graph / knn_distance_matrix layout)."""
    from scipy import sparse
    # copies: scipy mutates csr buffers in place, jax views are read-only
    idx = np.array(g.idx, dtype=np.int64)
    dist = np.array(g.dist, dtype=np.float64)
    n, kw = idx.shape
    return sparse.csr_matrix(
        (dist.ravel(), idx.ravel(), np.arange(0, n * kw + 1, kw)),
        shape=(g.n, g.n))


def weights_to_csr(g: KnnGraphDev, diag: float = 1.0):
    """Materialize the row-normalized smoothing-weight csr
    (connectivity_to_weights((knn > 0) with setdiag(diag)))."""
    from scipy import sparse
    knn = graph_to_csr(g)
    connectivity = (knn > 0).astype(float)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        connectivity.setdiag(diag)
    from .smoothing import connectivity_to_weights
    return connectivity_to_weights(connectivity)
