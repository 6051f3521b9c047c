import numpy as np
import pytest

from velocyto_tpu.ops import (col_delta_cor, col_delta_cor_partial,
                              col_delta_cor_partial_compact,
                              col_delta_cor_partial_sharded)
from velocyto_tpu.parallel import make_mesh

from oracles import col_delta_cor_dense as oracle_dense
from oracles import col_delta_cor_partial as oracle_partial


@pytest.mark.parametrize("transform,psc", [("linear", 0.0), ("sqrt", 0.0),
                                           ("sqrt", 1e-10), ("log10", 1.0)])
def test_dense_matches_oracle(rng, transform, psc):
    g, n = 37, 29
    e = rng.rand(g, n).astype(np.float64) * 10
    d = rng.randn(g, n).astype(np.float64)
    expected = oracle_dense(e, d, transform, psc)
    got = col_delta_cor(e, d, transform, psc)
    # the diagonal is 0/0 by construction and always overwritten downstream
    # (analysis fill_diagonal + nan handling); compare off-diagonal only
    mask = ~np.eye(n, dtype=bool)
    np.testing.assert_allclose(got[mask], expected[mask], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("transform,psc", [("linear", 0.0), ("sqrt", 1e-10),
                                           ("log10", 1.0)])
def test_partial_matches_oracle(rng, transform, psc):
    g, n, nn = 23, 31, 7
    e = rng.rand(g, n) * 10
    d = rng.randn(g, n)
    ixs = np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])
    expected = oracle_partial(e, d, ixs, transform, psc)
    got = col_delta_cor_partial_compact(e, d, ixs, transform, psc)
    np.testing.assert_allclose(got, expected, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("transform,psc", [("sqrt", 1e-10), ("log10", 1.0),
                                           ("log10", 1e-10)])
def test_dense_xla_padded_centre_blocks(rng, transform, psc):
    """The dense XLA path pads the centre cells to a multiple of its
    block; padded centres must not leak into real rows, including for
    transforms where transform(0) != 0 (sqrt/log10 with psc > 0)."""
    from velocyto_tpu.ops.coldeltacor import (_TRANSFORMS,
                                              _col_delta_cor_dense_xla)
    g, n, block = 37, 29, 8          # 29 centres -> 3 padded in 4 blocks
    e = rng.rand(g, n).astype(np.float64) * 10
    d = rng.randn(g, n).astype(np.float64)
    expected = oracle_dense(e, d, transform, psc)
    got = np.asarray(_col_delta_cor_dense_xla(
        e.astype(np.float32), d.astype(np.float32), _TRANSFORMS[transform],
        psc, block))
    assert got.shape == (n, n)
    mask = ~np.eye(n, dtype=bool)
    np.testing.assert_allclose(got[mask], expected[mask], rtol=2e-3,
                               atol=2e-3)


def test_partial_scatter_shape(rng):
    g, n, nn = 11, 13, 4
    e = rng.rand(g, n)
    d = rng.randn(g, n)
    ixs = np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])
    dense = col_delta_cor_partial(e, d, ixs, "sqrt", 1e-10)
    compact = col_delta_cor_partial_compact(e, d, ixs, "sqrt", 1e-10)
    for c in range(n):
        np.testing.assert_allclose(dense[c, ixs[c]], compact[c], rtol=1e-5)


def test_partial_sharded_matches_single(rng):
    g, n, nn = 17, 24, 5
    e = rng.rand(g, n)
    d = rng.randn(g, n)
    ixs = np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])
    mesh = make_mesh()  # 8 virtual CPU devices on the cells axis
    single = col_delta_cor_partial_compact(e, d, ixs, "sqrt", 1e-10)
    sharded = col_delta_cor_partial_sharded(mesh, e, d, ixs, "sqrt", 1e-10)
    np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("transform,psc", [("sqrt", 1e-10), ("sqrt", 0.0),
                                           ("log10", 1.0), ("linear", 0.0)])
def test_partial_equal_columns_match_oracle(rng, transform, psc):
    """Sampled pairs with exactly equal expression (delta == 0) follow
    the reference's partial-kernel quirks: |delta| < 1e-16 maps to 0
    for sqrt, and log10 takes the `>= 0` branch."""
    from velocyto_tpu.ops.coldeltacor import _partial_impl, _TRANSFORMS
    import jax.numpy as jnp
    g, n, nn = 23, 31, 7
    e = (rng.rand(g, n) * 10).astype(np.float32)
    e[:, 5] = e[:, 3]
    e[:, 17] = e[:, 3]
    d = rng.randn(g, n).astype(np.float32)
    ixs = np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])
    ixs[3, :2] = (5, 17)            # cell 3 samples its two twins
    ixs[5, 0] = 3
    got = np.asarray(_partial_impl(e.T, e.T, d.T,
                                   jnp.asarray(ixs, jnp.int32),
                                   _TRANSFORMS[transform], psc))
    expected = oracle_partial(e.astype(np.float64), d.astype(np.float64),
                              ixs, transform, psc)
    np.testing.assert_allclose(got, expected, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("transform,psc", [("sqrt", 1e-10), ("linear", 0.0)])
def test_partial_ring_matches_single(rng, transform, psc):
    """The ring-sharded variant (expression sharded over the mesh,
    ppermute rotation) must equal the single-device compact kernel."""
    from velocyto_tpu.ops.coldeltacor import col_delta_cor_partial_ring
    g, n, nn = 19, 53, 9    # n not divisible by 8 shards: padding path
    e = (rng.rand(g, n) * 10).astype(np.float32)
    d = rng.randn(g, n).astype(np.float32)
    ixs = np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])
    mesh = make_mesh()
    single = col_delta_cor_partial_compact(e, d, ixs, transform, psc)
    ring = col_delta_cor_partial_ring(mesh, e, d, ixs, transform, psc)
    np.testing.assert_allclose(ring, single, rtol=1e-4, atol=1e-5)


def test_ring_plan_roundtrip(rng):
    """The block-quantized plan's tables + inverse positions reconstruct
    the original neighbor order exactly, and every referenced block
    carries the right center row."""
    from velocyto_tpu.ops.coldeltacor import _ring_plan
    for n, nn, shards, q in ((37, 11, 8, 4), (64, 16, 4, 16),
                             (50, 13, 8, 16)):
        chunk = (n + shards - 1) // shards
        ixs = np.stack([rng.choice(n, nn, replace=False)
                        for _ in range(n)])
        qloc, qrow, inv_pos, bmax = _ring_plan(ixs, shards, chunk, q=q)
        for r in range(n):
            p = r // chunk
            pos = inv_pos[r].astype(np.int64)
            v = pos // (bmax * q)
            b = (pos % (bmax * q)) // q
            slot = pos % q
            rebuilt = qloc[p, v, b, slot] + v * chunk
            np.testing.assert_array_equal(rebuilt, ixs[r])
            np.testing.assert_array_equal(qrow[p, v, b],
                                          np.full(nn, r - p * chunk))


def test_sharded_routes_to_ring_over_threshold(rng, monkeypatch):
    """col_delta_cor_partial_sharded switches to the ring schedule when
    replicating the expression would exceed the per-chip budget."""
    import velocyto_tpu.ops.coldeltacor as cdc
    g, n, nn = 13, 40, 6
    e = rng.rand(g, n).astype(np.float32)
    d = rng.randn(g, n).astype(np.float32)
    ixs = np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])
    mesh = make_mesh()
    base = cdc.col_delta_cor_partial_compact(e, d, ixs, "sqrt", 1e-10)
    monkeypatch.setattr(cdc, "_REPLICATION_BYTES", 1)   # force ring
    routed = cdc.col_delta_cor_partial_sharded(mesh, e, d, ixs, "sqrt",
                                               1e-10)
    np.testing.assert_allclose(routed, base, rtol=1e-4, atol=1e-5)
