"""colDeltaCor: per-cell correlation between expression deltas and velocity.

For every cell ``c`` and candidate cell ``i``::

    A[:, i] = transform(e[:, i] - e[:, c])          # over genes
    corr[c, i] = pearson(A[:, i], d[:, c])

This is the computational core of velocity->embedding projection.  The
reference implements it as OpenMP C loops over cells
(reference: velocyto/speedboosted.pyx:13-538, python wrappers
velocyto/estimation.py:11-170).  Here it is re-derived as a streamed
moment accumulation, which needs only three running sums over genes per
(c, i) pair:

    S1 = sum_j A_ji      S2 = sum_j A_ji^2      S3 = sum_j A_ji * b_j

    num = S3 - S1 * sum(b) / G
    den = sqrt(S2 - S1^2 / G) * sqrt(sum b^2 - (sum b)^2 / G)
    corr = num / den

so both variants run as blocked fused-XLA code (dense: blocks of centre
cells against all candidates; neighbor-sampled: blocks of gathered
neighbor rows), with no O(G * N) scratch per cell.

Transforms match the reference sign conventions exactly:
  - "linear":  A = delta
  - "sqrt":    A = sign(delta) * sqrt(|delta| + psc); the *partial*
               variant maps |delta| < 1e-16 to exactly 0
               (speedboosted.pyx:373-378)
  - "log10":   A = sign(delta) * log10(|delta| + psc); full variant maps
               delta == 0 to -log10(psc) (`tmp > 0` test,
               speedboosted.pyx:195-199), partial maps it to +log10(psc)
               (`tmp >= 0` test, speedboosted.pyx:470-473)

All computation is float32 with every contraction at
``Precision.HIGHEST`` (true float32, never TF32); the reference uses
float64.  Agreement is validated to ~1e-4 relative in tests.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..parallel.mesh import CELLS

_LINEAR, _SQRT, _LOG10 = 0, 1, 2
_TRANSFORMS = {"linear": _LINEAR, "sqrt": _SQRT, "log10": _LOG10}


def _apply_transform(delta, transform: int, psc: float, partial: bool):
    if transform == _LINEAR:
        return delta
    if transform == _SQRT:
        mag = jnp.sqrt(jnp.abs(delta) + psc)
        if partial:
            # |delta| < 1e-16 -> exactly 0 (speedboosted.pyx:373-374)
            return jnp.where(jnp.abs(delta) < 1e-16, 0.0,
                             jnp.where(delta > 0, mag, -mag))
        # full variant: delta <= 0 goes to the negative branch
        return jnp.where(delta > 0, mag, -mag)
    if transform == _LOG10:
        mag = jnp.log10(jnp.abs(delta) + psc)
        if partial:
            # `tmp >= 0` test (speedboosted.pyx:470)
            return jnp.where(delta >= 0, mag, -mag)
        return jnp.where(delta > 0, mag, -mag)
    raise ValueError(f"unknown transform code {transform}")


def _corr_from_moments(s1, s2, s3, sb1, sb2, n_genes):
    num = s3 - s1 * (sb1 / n_genes)
    var_a = s2 - s1 * s1 / n_genes
    var_b = sb2 - sb1 * sb1 / n_genes
    return num / (jnp.sqrt(var_a) * jnp.sqrt(var_b))


# ---------------------------------------------------------------------------
# Dense (full) variant: blocked XLA
# ---------------------------------------------------------------------------

def _dense_xla_rows(emat: jax.Array, e_ctr: jax.Array, d_ctr: jax.Array,
                    transform: int = _LINEAR, psc: float = 0.0,
                    block: int = 8) -> jax.Array:
    """Dense colDeltaCor rows for a subset of center cells.

    emat: (G, N) full expression (candidate columns); e_ctr/d_ctr:
    (G, M) center-cell expression/displacement.  Returns (M, N).
    M may be a shard of N (see make_dense_sharded)."""
    g, n = emat.shape
    m = e_ctr.shape[1]
    m_pad = ((m + block - 1) // block) * block
    e = emat.astype(jnp.float32)
    e_c_all = jnp.pad(e_ctr.astype(jnp.float32), ((0, 0), (0, m_pad - m)))
    d_c_all = jnp.pad(d_ctr.astype(jnp.float32), ((0, 0), (0, m_pad - m)))

    def block_fn(c0):
        e_c = jax.lax.dynamic_slice(e_c_all, (0, c0), (g, block))  # (G, B)
        b = jax.lax.dynamic_slice(d_c_all, (0, c0), (g, block))    # (G, B)
        delta = e[:, :, None] - e_c[:, None, :]                  # (G, N, B)
        a = _apply_transform(delta, transform, psc, partial=False)
        s1 = jnp.sum(a, axis=0).T                                # (B, N)
        s2 = jnp.sum(a * a, axis=0).T
        s3 = jnp.einsum("gnb,gb->bn", a, b,
                        precision=jax.lax.Precision.HIGHEST)
        sb1 = jnp.sum(b, axis=0)[:, None]
        sb2 = jnp.sum(b * b, axis=0)[:, None]
        return _corr_from_moments(s1, s2, s3, sb1, sb2, float(g))

    blocks = jax.lax.map(block_fn, jnp.arange(0, m_pad, block))
    return blocks.reshape(m_pad, n)[:m]


@functools.partial(jax.jit, static_argnames=("transform", "psc", "block"))
def _col_delta_cor_dense_xla(emat: jax.Array, dmat: jax.Array,
                             transform: int = _LINEAR, psc: float = 0.0,
                             block: int = 8) -> jax.Array:
    return _dense_xla_rows(emat, emat, dmat, transform, psc, block)


# ---------------------------------------------------------------------------
# Partial (neighbor-sampled) variant: blocked gather + fused moments
# ---------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("transform", "psc", "block", "nt"))
def _partial_impl(e_full: jax.Array, e_ctr: jax.Array, d_ctr: jax.Array,
                  ixs: jax.Array, transform: int, psc: float,
                  block: int = 64, nt: int = 128) -> jax.Array:
    """Neighbor-sampled colDeltaCor.

    e_full: (N, G) gather source (cells-as-rows so neighbor gathers are
    contiguous); e_ctr/d_ctr: (M, G) center-cell expression/displacement
    rows; ixs: (M, nn) *global* neighbor indices.  Returns (M, nn).
    M may be a shard of N (see col_delta_cor_partial_sharded).

    The kernel is bound by the HBM row-gather of e_full.  Work is tiled
    as flat (center cell, nt-neighbor chunk) row units so the gathered
    (block, nt, G) intermediate -- and the transform applied to it --
    stays ~64 MB; the untiled form would materialize a (B, nn, G)
    temporary per block (~0.9 GB at 20k cells, 1.75k sampled neighbors,
    G=2k).
    """
    m, g = e_ctr.shape
    nn = ixs.shape[1]
    nt = min(nt, nn)
    nn_pad = ((nn + nt - 1) // nt) * nt
    nch = nn_pad // nt
    # flat row units: (cell i, neighbor chunk c) -> flat row i * nch + c
    flat = jnp.pad(ixs, ((0, 0), (0, nn_pad - nn))).reshape(m * nch, nt)
    mf = m * nch
    mf_pad = ((mf + block - 1) // block) * block
    flat = jnp.pad(flat, ((0, mf_pad - mf), (0, 0)))
    cell_of = jnp.minimum(jnp.arange(mf_pad, dtype=jnp.int32) // nch, m - 1)

    def block_fn(r0):
        cid = jax.lax.dynamic_slice(cell_of, (r0,), (block,))       # (B,)
        rows = e_ctr[cid]                                            # (B, G)
        b = d_ctr[cid]                                               # (B, G)
        nb_ix = jax.lax.dynamic_slice(flat, (r0, 0), (block, nt))    # (B, nt)
        e_nb = e_full[nb_ix]                                         # (B, nt, G)
        delta = e_nb - rows[:, None, :]
        a = _apply_transform(delta, transform, psc, partial=True)
        s1 = jnp.sum(a, axis=-1)                                     # (B, nt)
        s2 = jnp.sum(a * a, axis=-1)
        s3 = jnp.einsum("bng,bg->bn", a, b,
                        precision=jax.lax.Precision.HIGHEST)
        sb1 = jnp.sum(b, axis=-1)[:, None]
        sb2 = jnp.sum(b * b, axis=-1)[:, None]
        return _corr_from_moments(s1, s2, s3, sb1, sb2, float(g))

    blocks = jax.lax.map(block_fn, jnp.arange(0, mf_pad, block))
    out = blocks.reshape(mf_pad, nt)[:mf].reshape(m, nn_pad)
    return out[:, :nn]


def col_delta_cor(emat, dmat, transform: str = "linear", psc: float = 0.0,
                  mesh: Optional[Mesh] = None) -> np.ndarray:
    """Dense colDeltaCor. emat/dmat: (genes, cells). Returns (cells, cells).

    Replaces reference colDeltaCor / colDeltaCorSqrt / colDeltaCorLog10
    (velocyto/estimation.py:11-141) via the ``transform`` argument.
    With ``mesh``, center cells are sharded over the mesh CELLS axis
    (expression replicated, collective-free).
    """
    tcode = _TRANSFORMS[transform]
    emat = jnp.array(emat, dtype=jnp.float32)
    dmat = jnp.array(dmat, dtype=jnp.float32)
    if mesh is not None:
        return col_delta_cor_dense_sharded(mesh, emat, dmat, transform, psc)
    return np.array(_col_delta_cor_dense_xla(emat, dmat, tcode, psc))


def make_dense_sharded(mesh: Mesh, transform: str = "linear",
                       psc: float = 0.0, block: int = 8):
    """shard_map'd dense colDeltaCor over `mesh`: center cells sharded on
    the CELLS axis, expression replicated.  Signature:
    (emat (G, N), e_ctr (G, Np), d_ctr (G, Np)) -> (Np, N)."""
    tcode = _TRANSFORMS[transform]
    return shard_map(
        functools.partial(_dense_xla_rows, transform=tcode, psc=psc,
                          block=block),
        mesh=mesh,
        in_specs=(P(), P(None, CELLS), P(None, CELLS)),
        out_specs=P(CELLS, None),
    )


def col_delta_cor_dense_sharded(mesh: Mesh, emat, dmat,
                                transform: str = "linear",
                                psc: float = 0.0) -> np.ndarray:
    """Multi-chip dense colDeltaCor: rows of the (N, N) output sharded
    over the mesh CELLS axis.  Full-variant transform semantics (same as
    the single-device dense kernels)."""
    e = jnp.array(emat, dtype=jnp.float32)
    d = jnp.array(dmat, dtype=jnp.float32)
    g, n = e.shape
    shards = mesh.shape[CELLS]
    n_pad = ((n + shards - 1) // shards) * shards
    e_ctr = jnp.pad(e, ((0, 0), (0, n_pad - n)))
    d_ctr = jnp.pad(d, ((0, 0), (0, n_pad - n)))
    fn = make_dense_sharded(mesh, transform, psc)
    out = fn(e, e_ctr, d_ctr)
    return np.array(out[:n])


def col_delta_cor_partial_compact_dev(emat, dmat, ixs,
                                      transform: str = "linear",
                                      psc: float = 0.0) -> jax.Array:
    """Sampled-neighborhood colDeltaCor returning the compact (N, nn) form
    as a device array (no host transfer — downstream consumers like the
    compact embedding shift stay on device)."""
    tcode = _TRANSFORMS[transform]
    e_rows = jnp.array(emat, dtype=jnp.float32).T
    d_rows = jnp.array(dmat, dtype=jnp.float32).T
    ixs = jnp.array(ixs, dtype=jnp.int32)
    return _partial_impl(e_rows, e_rows, d_rows, ixs, tcode, psc)


def make_partial_compact_chunked(emat, transform: str = "linear",
                                 psc: float = 0.0):
    """Row-chunked sampled colDeltaCor for pipelining behind the
    neighbor-sampling producer: kernels for rows [lo, hi) depend only on
    that chunk's sampled indices, so their device work overlaps the
    (host) sampling of later chunks (estimate_transition_prob).

    Returns (prep_d, run): prep_d transposes/uploads a displacement
    matrix once; run(d_rows, lo, hi, ixs_chunk) evaluates the compact
    (hi-lo, nn) block.  Concatenating the blocks row-wise equals the
    unchunked col_delta_cor_partial_compact_dev exactly (rows are
    independent)."""
    tcode = _TRANSFORMS[transform]
    e_rows = jnp.array(emat, dtype=jnp.float32).T

    def prep_d(dmat):
        return jnp.array(dmat, dtype=jnp.float32).T

    def run(d_rows, lo: int, hi: int, ixs_chunk) -> jax.Array:
        return _partial_impl(e_rows, e_rows[lo:hi], d_rows[lo:hi],
                             jnp.asarray(ixs_chunk, jnp.int32), tcode, psc)

    return prep_d, run


def col_delta_cor_partial_compact(emat, dmat, ixs, transform: str = "linear",
                                  psc: float = 0.0) -> np.ndarray:
    """Sampled-neighborhood colDeltaCor returning the compact (N, nn) form."""
    return np.array(
        col_delta_cor_partial_compact_dev(emat, dmat, ixs, transform, psc))


def col_delta_cor_partial(emat, dmat, ixs, transform: str = "linear",
                          psc: float = 0.0,
                          mesh: Optional[Mesh] = None) -> np.ndarray:
    """Sampled-neighborhood colDeltaCor, scattered into a dense (N, N) array
    for API parity with the reference (velocyto/estimation.py:36-62,144-170).
    With ``mesh``, center cells are sharded over the mesh CELLS axis.
    """
    if mesh is not None:
        compact = col_delta_cor_partial_sharded(mesh, emat, dmat, ixs,
                                                transform, psc)
    else:
        compact = col_delta_cor_partial_compact(emat, dmat, ixs, transform,
                                                psc)
    n = emat.shape[1]
    out = np.zeros((n, n), dtype=np.float64)
    rows = np.repeat(np.arange(n), np.array(ixs).shape[1])
    np.add.at(out, (rows, np.array(ixs).ravel()), compact.ravel())
    return out


def make_partial_sharded(mesh: Mesh, transform: str = "linear",
                         psc: float = 0.0):
    """Build the shard_map'd partial-colDeltaCor callable for `mesh`
    (cells axis sharded, expression replicated).  Signature:
    (e_rows (N,G), e_shard (Np,G), d_shard (Np,G), ixs (Np,nn)) ->
    (Np, nn) device array; Np must divide by the mesh's cells axis."""
    tcode = _TRANSFORMS[transform]
    return shard_map(
        functools.partial(_partial_impl, transform=tcode, psc=psc),
        mesh=mesh,
        in_specs=(P(), P(CELLS, None), P(CELLS, None), P(CELLS, None)),
        out_specs=P(CELLS, None),
    )


# Replicated-expression budget per device for devices that report no
# memory limit (the CPU backend).  Devices that do report one allow a
# quarter of it: the replicated (N, G) matrix shares the device with
# the (N, nn) neighbor/correlation state and the kernel's gather tiles.
_REPLICATION_BYTES = 4 << 30


def _replication_budget(mesh: Mesh) -> int:
    """Bytes of replicated expression one device of `mesh` may hold
    before the sharded partial kernel switches to the ring schedule."""
    stats = mesh.devices.flat[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return limit // 4 if limit else _REPLICATION_BYTES


def col_delta_cor_partial_sharded_dev(mesh: Mesh, emat, dmat, ixs,
                                      transform: str = "linear",
                                      psc: float = 0.0) -> jax.Array:
    """Multi-chip partial colDeltaCor: center cells (rows of ixs / output)
    sharded over the mesh "cells" axis, expression replicated.
    Collective-free: each shard gathers from the replicated expression
    matrix, so scaling is embarrassingly parallel over the devices.
    When the replicated expression would exceed the per-device budget
    (:func:`_replication_budget`), the ring schedule (expression
    sharded, ppermute rotation) takes over.  Returns the compact
    (N, nn) form as a device array (still sharded).
    """
    if np.asarray(emat).size * 4 > _replication_budget(mesh):
        return col_delta_cor_partial_ring_dev(mesh, emat, dmat, ixs,
                                              transform, psc)
    e_rows = jnp.array(emat, dtype=jnp.float32).T
    d_rows = jnp.array(dmat, dtype=jnp.float32).T
    ixs = jnp.array(ixs, dtype=jnp.int32)
    n = e_rows.shape[0]
    shards = mesh.shape[CELLS]
    n_pad = ((n + shards - 1) // shards) * shards
    e_pad = jnp.pad(e_rows, ((0, n_pad - n), (0, 0)))
    d_pad = jnp.pad(d_rows, ((0, n_pad - n), (0, 0)))
    ixs_pad = jnp.pad(ixs, ((0, n_pad - n), (0, 0)))

    fn = make_partial_sharded(mesh, transform, psc)
    return fn(e_rows, e_pad, d_pad, ixs_pad)[:n]


def col_delta_cor_partial_sharded(mesh: Mesh, emat, dmat, ixs,
                                  transform: str = "linear",
                                  psc: float = 0.0) -> np.ndarray:
    """Host-returning form of :func:`col_delta_cor_partial_sharded_dev`."""
    return np.array(
        col_delta_cor_partial_sharded_dev(mesh, emat, dmat, ixs,
                                          transform, psc))


# ---------------------------------------------------------------------------
# Ring variant: expression sharded too (no per-chip replication)
# ---------------------------------------------------------------------------
#
# col_delta_cor_partial_sharded keeps the full (N, G) expression matrix on
# every chip, which caps N at the per-chip HBM.  The ring variant shards
# the expression over the mesh CELLS axis as well and rotates each chunk
# around the ring with lax.ppermute (classic systolic schedule, SURVEY §7
# Phase 3): chip p at step s holds chunk (p + s) % P and evaluates exactly
# the sampled pairs whose neighbor lives in that chunk.  Per-chip memory
# is O(N/P * G); communication is the (P-1)-step ring of (N/P, G) chunks
# over the device interconnect.
#
# The neighbor indices are pre-grouped by owning chunk on the host (the
# order of neighbors within a row is irrelevant to the per-pair moments),
# padded per (row, owner) to the global max group size M, and the compact
# output is un-permuted on device with one take_along_axis.


def _ring_plan(ixs: np.ndarray, shards: int, chunk: int, q: int = 16):
    """Block-quantized grouping of each row's neighbor indices by owning
    chunk (round 4; replaces the padded-per-(row, owner) group table).

    The old layout padded every (row, owner) group to the GLOBAL max
    group size, and that multinomial-tail inflation (1.25x at P=8,
    20k/1750) was the entire modeled efficiency deficit of the ring
    schedule.  Here each (row, owner) group is packed into ceil(cnt/q)
    blocks of q entries, and only the per-(chip, owner) BLOCK COUNT is
    padded to the global max -- a sum of ~chunk-many ceils whose max is
    CLT-tight, so the waste collapses to ~q/2 per group (~4% at the
    same operating point).

    Returns (qloc (P, P, Bmax, q) int32 chunk-local neighbor indices,
    qrow (P, P, Bmax) int32 chunk-local center row of each block,
    inv_pos (N, nn) int32 positions into the per-chip (P*Bmax*q) output
    layout, Bmax).  Dummy blocks/slots hold zeros; their outputs are
    never referenced by inv_pos.
    """
    n, nn = ixs.shape
    n_pad = chunk * shards
    owner = (ixs // chunk).astype(np.int64)
    local = (ixs - owner * chunk).astype(np.int32)
    order = np.argsort(owner, axis=1, kind="stable")
    owner_s = np.take_along_axis(owner, order, axis=1)
    local_s = np.take_along_axis(local, order, axis=1)
    rows_rep = np.repeat(np.arange(n), nn)
    counts = np.zeros((n, shards), np.int64)
    np.add.at(counts, (rows_rep, owner.ravel()), 1)
    blocks = -(-counts // q)                            # (n, P) ceil
    # exclusive cumsum of block counts over the rows of each chip
    blk_start = np.zeros((n, shards), np.int64)
    bc = np.zeros((shards, shards), np.int64)           # (chip, owner)
    for p in range(shards):
        sl = slice(p * chunk, min((p + 1) * chunk, n))
        blk_start[sl] = np.cumsum(blocks[sl], axis=0) - blocks[sl]
        bc[p] = blocks[sl].sum(axis=0)
    bmax = max(1, int(bc.max()))

    starts_in_row = np.zeros((n, shards), np.int64)
    starts_in_row[:, 1:] = np.cumsum(counts, axis=1)[:, :-1]
    t = np.arange(nn)[None, :] - np.take_along_axis(starts_in_row,
                                                    owner_s, axis=1)
    b_idx = np.take_along_axis(blk_start, owner_s, axis=1) + t // q
    slot = t % q
    chip_of = (np.arange(n) // chunk)[:, None]
    row_local = (np.arange(n) - (np.arange(n) // chunk) * chunk
                 ).astype(np.int32)

    qloc = np.zeros((shards, shards, bmax, q), np.int32)
    qrow = np.zeros((shards, shards, bmax), np.int32)
    qloc[np.broadcast_to(chip_of, owner_s.shape), owner_s, b_idx,
         slot] = local_s
    qrow[np.broadcast_to(chip_of, owner_s.shape), owner_s,
         b_idx] = np.broadcast_to(row_local[:, None], owner_s.shape)
    pos_s = owner_s * (bmax * q) + b_idx * q + slot
    inv_pos = np.zeros((n_pad, nn), np.int64)
    np.put_along_axis(inv_pos[:n], order, pos_s, axis=1)
    return qloc, qrow, inv_pos.astype(np.int32), bmax


@functools.partial(jax.jit,
                   static_argnames=("transform", "psc", "block"))
def _partial_flat_impl(e_full: jax.Array, e_ctr: jax.Array,
                       d_ctr: jax.Array, qloc: jax.Array, qrow: jax.Array,
                       transform: int, psc: float,
                       block: int = 512) -> jax.Array:
    """_partial_impl over an explicit flat block table: qloc (F, q)
    gather-source rows per block, qrow (F,) center row of each block.
    Returns (F, q) correlations.  Same tiling/moment math as
    _partial_impl; the center row amortizes over the q entries of its
    block exactly like the nt-neighbor chunks there."""
    f, q = qloc.shape
    g = e_ctr.shape[1]
    block = max(8, min(block, (1 << 24) // max(1, q * g), f))
    f_pad = ((f + block - 1) // block) * block
    qloc_p = jnp.pad(qloc, ((0, f_pad - f), (0, 0)))
    qrow_p = jnp.pad(qrow, ((0, f_pad - f),))

    def block_fn(r0):
        cid = jax.lax.dynamic_slice(qrow_p, (r0,), (block,))
        rows = e_ctr[cid]                                         # (B, G)
        b = d_ctr[cid]
        nb_ix = jax.lax.dynamic_slice(qloc_p, (r0, 0), (block, q))
        e_nb = e_full[nb_ix]                                      # (B,q,G)
        delta = e_nb - rows[:, None, :]
        a = _apply_transform(delta, transform, psc, partial=True)
        s1 = jnp.sum(a, axis=-1)
        s2 = jnp.sum(a * a, axis=-1)
        s3 = jnp.einsum("bng,bg->bn", a, b,
                        precision=jax.lax.Precision.HIGHEST)
        sb1 = jnp.sum(b, axis=-1)[:, None]
        sb2 = jnp.sum(b * b, axis=-1)[:, None]
        return _corr_from_moments(s1, s2, s3, sb1, sb2, float(g))

    blocks = jax.lax.map(block_fn, jnp.arange(0, f_pad, block))
    return blocks.reshape(f_pad, q)[:f]


def make_partial_ring(mesh: Mesh, shards: int, bmax: int, qwidth: int,
                      nn: int, transform: str = "linear",
                      psc: float = 0.0):
    """Build the shard_map'd ring partial-colDeltaCor callable over the
    block-quantized plan.

    Signature: (e_shard (C, G), d_shard (C, G), qloc (1, P, Bmax, q),
    qrow (1, P, Bmax), inv_pos (C, nn)) -> (C, nn); expression/output
    sharded on CELLS, one (P, Bmax[, q]) table slice per chip.
    """
    tcode = _TRANSFORMS[transform]
    perm = [(i, (i - 1) % shards) for i in range(shards)]

    def ring_fn(e_shard, d_shard, qloc, qrow, inv_pos):
        p = jax.lax.axis_index(CELLS)
        qloc = qloc[0]                  # (P, Bmax, q)
        qrow = qrow[0]                  # (P, Bmax)
        out0 = jnp.zeros((shards, bmax, qwidth), jnp.float32)
        # the carry becomes device-varying once p enters the body; the
        # initial value must carry the same manual-axes annotation
        out0 = jax.lax.pcast(out0, (CELLS,), to="varying")

        def body(carry, s):
            e_visit, out = carry
            v = jax.lax.rem(p + s, shards)
            # issue the rotation BEFORE the block-table compute: both
            # read only e_visit, so XLA's async collective scheduler can
            # overlap the transfer with the step's compute
            e_next = jax.lax.ppermute(e_visit, CELLS, perm)
            loc_v = jax.lax.dynamic_index_in_dim(qloc, v, axis=0,
                                                 keepdims=False)
            row_v = jax.lax.dynamic_index_in_dim(qrow, v, axis=0,
                                                 keepdims=False)
            part = _partial_flat_impl(e_visit, e_shard, d_shard,
                                      loc_v, row_v, tcode, psc)
            out = jax.lax.dynamic_update_slice(out, part[None],
                                               (v, 0, 0))
            return (e_next, out), None

        (_, out), _ = jax.lax.scan(body, (e_shard, out0),
                                   jnp.arange(shards, dtype=jnp.int32))
        return jnp.take(out.reshape(shards * bmax * qwidth),
                        inv_pos, axis=0)

    return shard_map(ring_fn, mesh=mesh,
                     in_specs=(P(CELLS, None), P(CELLS, None),
                               P(CELLS, None, None, None),
                               P(CELLS, None, None), P(CELLS, None)),
                     out_specs=P(CELLS, None))


def col_delta_cor_partial_ring_dev(mesh: Mesh, emat, dmat, ixs,
                                   transform: str = "linear",
                                   psc: float = 0.0) -> jax.Array:
    """Fully-sharded sampled colDeltaCor (expression sharded, ring
    rotation) returning the compact (N, nn) device array.  Numerically
    identical per pair to the replicated-sharded and single-device
    paths (same f32 moment accumulation)."""
    e_rows = jnp.array(emat, dtype=jnp.float32).T
    d_rows = jnp.array(dmat, dtype=jnp.float32).T
    ixs = np.asarray(ixs)
    n = e_rows.shape[0]
    nn = ixs.shape[1]
    shards = mesh.shape[CELLS]
    chunk = (n + shards - 1) // shards
    n_pad = chunk * shards
    qwidth = min(16, nn)
    qloc, qrow, inv_pos, bmax = _ring_plan(ixs, shards, chunk, q=qwidth)
    e_pad = jnp.pad(e_rows, ((0, n_pad - n), (0, 0)))
    d_pad = jnp.pad(d_rows, ((0, n_pad - n), (0, 0)))
    fn = make_partial_ring(mesh, shards, bmax, qwidth, nn, transform, psc)
    return fn(e_pad, d_pad, jnp.asarray(qloc), jnp.asarray(qrow),
              jnp.asarray(inv_pos))[:n]


def col_delta_cor_partial_ring(mesh: Mesh, emat, dmat, ixs,
                               transform: str = "linear",
                               psc: float = 0.0) -> np.ndarray:
    """Host-returning form of :func:`col_delta_cor_partial_ring_dev`."""
    return np.array(col_delta_cor_partial_ring_dev(mesh, emat, dmat, ixs,
                                                   transform, psc))
