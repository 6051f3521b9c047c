"""Comparisons of the device estimation pipeline with plain references.

One module for both callers: ``chip_smoke.py`` runs them on the card at
the reference's documented operating point (20,000 cells x 2,000 genes,
k=500, b_sight=3000, n_neighbors=3500), the ``gpu``-marked tests run
them at the same width, and the CPU tests run them at a tiny size.
Every device result is float32 and every reference float64; every device
contraction runs at ``Precision.HIGHEST``, so the tolerances below are
float32 ones.

Each check returns a result dict (name, largest absolute and relative
error, tolerance, ok) and raises nothing itself: the caller prints every
result and fails if any is not ok.
"""
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import oracles  # noqa: E402

# reference operating point (doc/tutorial/analysis.rst:109,163-164)
FULL = dict(cells=20000, genes=2000, k=500, b_sight=3000, b_maxl=1500,
            n_neighbors=3500)
# the same pipeline small enough for a CPU test
TINY = dict(cells=400, genes=64, k=12, b_sight=48, b_maxl=24,
            n_neighbors=80)
PSC = 1e-10                     # estimate_transition_prob's sqrt default

# (rtol, atol): the repo's pinned colDeltaCor tolerances
# (tests/test_coldeltacor.py), set by float32 moment sums over the genes
CORR_TOL = (2e-3, 2e-4)
SMOOTH_RTOL = 1e-5


def synth(seed: int, cells: int, genes: int):
    """Synthetic low-rank Poisson (S, U) counts, (genes, cells) float32."""
    from bench_pipeline import synth as _synth
    return _synth(np.random.RandomState(seed), cells, genes)


def run_pipeline(S, U, p: dict, mesh=None, log=print):
    """The estimation pipeline at parameters `p` (FULL or TINY).
    Returns (total seconds, {stage: seconds}, VelocytoLoom)."""
    from bench_pipeline import run_once
    return run_once(S, U, k=p["k"], b_sight=p["b_sight"],
                    b_maxl=p["b_maxl"], n_neighbors=p["n_neighbors"],
                    randomized=True, mesh=mesh, log=log)


def compare(name: str, got, want, rtol: float, atol: float = 0.0,
            mask=None) -> dict:
    """np.isclose-style comparison (NaN never matches)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return {"name": name, "ok": False,
                "detail": f"shape {got.shape} != {want.shape}"}
    if mask is not None:
        got, want = got[mask], want[mask]
    err = np.abs(got - want)
    rel = err / np.maximum(np.abs(want), np.finfo(np.float64).tiny)
    ok = bool(np.all(np.isclose(got, want, rtol=rtol, atol=atol)))
    return {"name": name, "ok": ok, "max_abs": float(np.nanmax(err)),
            "max_rel": float(np.nanmax(rel)), "rtol": rtol, "atol": atol,
            "n": int(got.size)}


def _sampled_inputs(v):
    """(Sx_sz, transformed displacement) exactly as the run's sampled
    transition step fed them to the kernel, as device arrays (G, N)."""
    from velocyto_tpu.analysis import _corr_transform_dev
    hi32 = v._get_dev("Sx_sz")
    d = _corr_transform_dev(hi32, v._get_dev("delta_S"), v.used_delta_t,
                            PSC, "sqrt")
    return hi32, d


def check_sampled_coldeltacor(v, n_centre: int = 256) -> dict:
    """The main-path kernel (_partial_impl) on the run's own Sx_sz,
    displacement and sampled neighbours, for the first n_centre cells,
    against the float64 oracle."""
    import jax.numpy as jnp
    from velocyto_tpu.ops.coldeltacor import _TRANSFORMS, _partial_impl
    hi32, d = _sampled_inputs(v)
    m = min(n_centre, hi32.shape[1])
    ixs = np.asarray(v._compact_ixs_dev[:m], dtype=np.int64)
    e_rows, d_rows = hi32.T, d.T
    got = _partial_impl(e_rows, e_rows[:m], d_rows[:m],
                        jnp.asarray(ixs, jnp.int32), _TRANSFORMS["sqrt"],
                        PSC)
    want = oracles.col_delta_cor_partial(
        np.asarray(hi32, np.float64), np.asarray(d, np.float64), ixs,
        "sqrt", PSC)
    return compare(f"sampled colDeltaCor G={hi32.shape[0]} "
                   f"nn={ixs.shape[1]} centres={m}", got, want, *CORR_TOL)


def check_knn_graph(v, p: dict) -> dict:
    """Device balanced kNN graph against the host path (f32 candidate
    pass, float64 numpy re-score, native greedy loop): identical
    neighbour indices."""
    from velocyto_tpu.ops.knn import BalancedKNN
    dev = np.asarray(v._knn_graph_dev.idx, dtype=np.int64)
    bknn = BalancedKNN(k=p["k"], sight_k=p["b_sight"], maxl=p["b_maxl"],
                       mode="distance")
    bknn.fit(v.pcs)
    _dist, host, _l = bknn.kneighbors(mode="distance")
    host = np.asarray(host, dtype=np.int64)
    same_shape = dev.shape == host.shape
    n_diff = int(np.sum(dev != host)) if same_shape else -1
    return {"name": f"balanced kNN indices N={dev.shape[0]} "
                    f"k={p['k']} sight={p['b_sight']}",
            "ok": same_shape and n_diff == 0, "n_unequal": n_diff,
            "n": int(dev.size)}


def check_smoothed_sx(v) -> dict:
    """Device Sx against a scipy-sparse float64 convolution of S_sz over
    the same graph and weights."""
    from velocyto_tpu.ops import knn_device as kd
    w = kd.weights_to_csr(v._knn_graph_dev, diag=v._knn_diag)
    s_sz = np.asarray(v.S_sz, dtype=np.float64)
    want = np.asarray(w @ np.ascontiguousarray(s_sz.T)).T
    return compare(f"smoothed Sx {want.shape}", v.Sx, want, SMOOTH_RTOL)


def check_dense_coldeltacor(e, d, rows: int = 64) -> tuple:
    """Dense colDeltaCor through XLA (the knn_random=False kernel) on
    (G, N) inputs; the first `rows` rows against the float64 oracle.
    Returns (result, warm seconds of one full (N, N) call)."""
    import jax
    import jax.numpy as jnp
    from velocyto_tpu.ops.coldeltacor import (_TRANSFORMS,
                                              _col_delta_cor_dense_xla)
    e32 = jnp.asarray(e, jnp.float32)
    d32 = jnp.asarray(d, jnp.float32)
    tcode = _TRANSFORMS["sqrt"]
    out = jax.block_until_ready(
        _col_delta_cor_dense_xla(e32, d32, tcode, PSC))
    t0 = time.perf_counter()
    jax.block_until_ready(_col_delta_cor_dense_xla(e32, d32, tcode, PSC))
    dt = time.perf_counter() - t0
    rows = min(rows, e.shape[1])
    want = oracles.col_delta_cor_dense(
        np.asarray(e32, np.float64), np.asarray(d32, np.float64), "sqrt",
        PSC, centres=range(rows))
    # the diagonal is 0/0 by construction (overwritten downstream)
    off_diag = np.ones(want.shape, bool)
    off_diag[np.arange(rows), np.arange(rows)] = False
    res = compare(f"dense colDeltaCor (XLA) G={e.shape[0]} N={e.shape[1]} "
                  f"rows={rows}", np.asarray(out)[:rows], want, *CORR_TOL,
                  mask=off_diag)
    return res, dt


def single_card_checks(v, p: dict, dense_cells: int = 3072) -> list:
    """Every one-card comparison of the pipeline run `v` at parameters p."""
    hi32, d = _sampled_inputs(v)
    n = min(dense_cells, hi32.shape[1])
    dense, dense_s = check_dense_coldeltacor(hi32[:, :n], d[:, :n])
    dense["warm_seconds_full_call"] = dense_s
    return [check_sampled_coldeltacor(v), check_knn_graph(v, p),
            check_smoothed_sx(v), dense]


def mesh_checks(vm, v1) -> list:
    """A mesh run against the one-device run of the same data."""
    out = []
    im = np.asarray(vm._knn_graph_dev.idx)
    i1 = np.asarray(v1._knn_graph_dev.idx)
    n_diff = int(np.sum(im != i1)) if im.shape == i1.shape else -1
    out.append({"name": "mesh vs one device: kNN indices",
                "ok": n_diff == 0, "n_unequal": n_diff, "n": int(im.size)})
    out.append(compare("mesh vs one device: Sx", vm.Sx, v1.Sx, 1e-6, 1e-6))
    finite = bool(np.all(np.isfinite(vm.delta_embedding)))
    de = compare("mesh vs one device: delta_embedding", vm.delta_embedding,
                 v1.delta_embedding, 1e-3, 1e-5)
    de["ok"] = de["ok"] and finite
    out.append(de)
    return out


def ring_check(mesh, v) -> dict:
    """Ring-scheduled sampled colDeltaCor over `mesh` against the
    one-device kernel on the run's own inputs."""
    from velocyto_tpu.ops.coldeltacor import (
        col_delta_cor_partial_compact, col_delta_cor_partial_ring)
    hi32, d = _sampled_inputs(v)
    e = np.asarray(hi32)
    dd = np.asarray(d)
    ixs = np.asarray(v._compact_ixs_dev)
    single = col_delta_cor_partial_compact(e, dd, ixs, "sqrt", PSC)
    ring = col_delta_cor_partial_ring(mesh, e, dd, ixs, "sqrt", PSC)
    return compare(f"ring vs one device: sampled colDeltaCor "
                   f"G={e.shape[0]} N={e.shape[1]} nn={ixs.shape[1]}",
                   ring, single, 1e-4, 1e-5)


def format_result(r: dict) -> str:
    parts = [("PASS" if r["ok"] else "FAIL"), r["name"]]
    for key in ("max_abs", "max_rel", "rtol", "atol", "n_unequal", "n",
                "warm_seconds_full_call", "detail"):
        if key in r:
            parts.append(f"{key}={r[key]}")
    return "  ".join(str(x) for x in parts)
