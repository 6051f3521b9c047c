"""Sub-stage attribution for the two dominant pipeline stages.

Splits
  - estimate_transition_prob (20k x 2k, nn=3500, frac=0.5, randomized)
    into embedding-kNN / RNG sampling / neighbor gather / displacement
    transform / main corr kernel / randomized corr kernel
  - the 50k balanced kNN into candidate sort / f64 rescore /
    reorder+truncate / hub order / balance scan
and prints a JSON sub-table.  A D=50 distance-matmul probe runs before
and after each section, so a section measured while the device was
shared shows up as a slow probe.
"""
import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("VTPU_BENCH", "1")


import jax  # noqa: E402

from bench_common import matmul_probe  # noqa: E402


def timed(name, fn, out, n=1, warm=True):
    if warm and os.environ.get("VTPU_ATTR_WARM", "1") == "1":
        jax.block_until_ready(fn())   # compile outside timing
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / n
    out[name] = round(dt, 3)
    print(f"#   {name}: {dt:.3f}s", flush=True)
    return r


def attr_transition(n=20000, g=2000, nn=3500, frac=0.5):
    import jax.numpy as jnp
    from velocyto_tpu.ops import knn_device as kd
    from velocyto_tpu.ops.coldeltacor import col_delta_cor_partial_compact_dev
    from velocyto_tpu import native as _native
    from velocyto_tpu.analysis import (_corr_transform_dev,
                                       _permute_rows_nsign_plan,
                                       _permute_apply_dev,
                                       _sample_neighbors_dev)

    out = {}
    rng = np.random.RandomState(0)
    emb = rng.randn(n, 2).astype(np.float64) * 10
    Sx = jnp.asarray(rng.gamma(2., 1., (g, n)).astype(np.float32))
    dS = jnp.asarray(rng.randn(g, n).astype(np.float32) * 0.1)
    nn_k = min(nn + 1, n - 1)

    print("# transition_prob attribution", flush=True)
    p0 = matmul_probe()
    print(f"#   probe_before: {p0:.2f}ms", flush=True)

    idx_dev = timed("embedding_knn", lambda: kd.knn_search_dev(
        emb, min(nn_k + 1, n))[1], out)
    p = np.linspace(0.5, 0.1, nn_k)
    p = p / p.sum()
    n_samp = int(frac * nn_k)

    def draw():
        r = _native.choice_noreplace_rows_state(15071990, n, nn_k, n_samp, p)
        return r[0]
    samp = timed("rng_sampling(native)", draw, out)
    samp_dev = jnp.asarray(samp.astype(np.uint16))
    neigh_ixs = timed("sample_gather(fused)", lambda: _sample_neighbors_dev(
        idx_dev, samp_dev), out)

    perms, signs = _permute_rows_nsign_plan(g, n)
    from velocyto_tpu.analysis import _invert_rows
    inv = jnp.asarray(_invert_rows(perms))
    dS_r = timed("permute_rndm(sort)", lambda: _permute_apply_dev(
        dS, inv, jnp.asarray(signs)), out)
    d_main = timed("transform_main", lambda: _corr_transform_dev(
        Sx, dS, 1.0, 1e-10, "sqrt"), out)
    d_rndm = timed("transform_rndm", lambda: _corr_transform_dev(
        Sx, dS_r, 1.0, 1e-10, "sqrt"), out)
    timed("corr_kernel_main", lambda: col_delta_cor_partial_compact_dev(
        Sx, d_main, neigh_ixs, "sqrt", 1e-10), out)
    timed("corr_kernel_rndm", lambda: col_delta_cor_partial_compact_dev(
        Sx, d_rndm, neigh_ixs, "sqrt", 1e-10), out)
    p1 = matmul_probe()
    print(f"#   probe_after: {p1:.2f}ms", flush=True)
    out["probe_ms"] = [round(p0, 2), round(p1, 2)]
    out["sum"] = round(sum(v for k, v in out.items()
                           if isinstance(v, float)), 2)
    return out


def attr_knn50k(n=50000, d=50, k=500, sight=3000, maxl=1500):
    import jax.numpy as jnp
    from velocyto_tpu.ops import knn_device as kd
    from velocyto_tpu.ops.knn import _candidate_plan, _knn_search_impl

    out = {}
    rng = np.random.RandomState(0)
    x = (rng.randn(n, d) @ np.diag(np.linspace(3, 0.3, d))).astype(
        np.float32)
    x64 = jnp.asarray(x.astype(np.float64), dtype=jnp.float64)
    kk = sight + 1
    k2, blk, use_sort = _candidate_plan(n, kk, 512)

    print(f"# knn50k attribution (n={n}, sight={sight}, k={k})", flush=True)
    p0 = matmul_probe()
    print(f"#   probe_before: {p0:.2f}ms", flush=True)

    cand = timed("candidate_sort", lambda: _knn_search_impl(
        jnp.asarray(x), k2, blk, "euclidean", use_sort)[1], out)
    rb = max(8, min(256, (1 << 25) // max(1, k2 * d)))
    d2 = timed("rescore_f64", lambda: kd._rescore_f64_impl(x64, cand, rb),
               out)
    dd, ii = timed("reorder_truncate", lambda: kd._reorder_truncate_impl(
        d2, cand, kk), out)
    dist = jnp.sqrt(jnp.maximum(dd, 0.0))
    lsi = timed("hub_order", lambda: kd._hub_order_impl(ii), out)
    cst = jnp.zeros((n,), jnp.int32)
    timed("balance_scan", lambda: kd._balance_scan_impl(
        ii, dist, lsi, cst, maxl, k, False), out)
    p1 = matmul_probe()
    print(f"#   probe_after: {p1:.2f}ms", flush=True)
    out["probe_ms"] = [round(p0, 2), round(p1, 2)]
    out["sum"] = round(sum(v for kx, v in out.items()
                           if isinstance(v, float)), 2)
    return out


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    res = {}
    if which in ("both", "transition"):
        res["transition_prob_substages"] = attr_transition()
    if which in ("both", "knn50k"):
        res["knn_50k_substages"] = attr_knn50k()
    print(json.dumps(res, indent=1))
