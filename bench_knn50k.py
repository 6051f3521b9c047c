"""50k-cell balanced-kNN benchmark (the reference's b_sight=3000/k=500
operating point scaled to 50k cells), fully device-resident.

Measurement policy: run 0 is always a warmup (compilation) and never
enters the statistic; the headline is the median of the clean measured
runs (default 6 reps -> 1 warmup + 5 measured) with the stage split from
the run closest to the median; min/max spread recorded.  Prints one JSON
line.
"""
import json
import os
import time

import numpy as np

N = int(os.environ.get("VTPU_BENCH_KNN_CELLS", 50000))
D, K, SIGHT, MAXL = 50, 500, 3000, 1500
REPS = int(os.environ.get("VTPU_BENCH_KNN_REPS", 6))
PROBE_MS = float(os.environ.get("VTPU_BENCH_PROBE_MS", 8.0))


from bench_common import matmul_probe  # noqa: E402


def run_once(x, x64):
    import jax.numpy as jnp
    from velocyto_tpu.ops import knn_device as kd
    from velocyto_tpu.ops.knn import _candidate_plan, _knn_search_impl

    stages = {}

    def timed(name, fn):
        import jax
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn())
        stages[name] = round(time.perf_counter() - t0, 2)
        return r

    kk = SIGHT + 1
    k2, blk, use_sort = _candidate_plan(N, kk, 512)
    t_all = time.perf_counter()
    cand = timed("candidate_sort", lambda: _knn_search_impl(
        jnp.asarray(x), k2, blk, "euclidean", use_sort)[1])
    rb = max(8, min(256, (1 << 25) // max(1, k2 * D)))
    d2 = timed("rescore_f64", lambda: kd._rescore_f64_impl(x64, cand, rb))
    dd, ii = timed("reorder_truncate", lambda: kd._reorder_truncate_impl(
        d2, cand, kk))
    dist = jnp.sqrt(jnp.maximum(dd, 0.0))
    lsi = timed("hub_order", lambda: kd._hub_order_impl(ii))
    cst = jnp.zeros((N,), jnp.int32)
    timed("balance_scan", lambda: kd._balance_scan_impl(
        ii, dist, lsi, cst, MAXL, K, False))
    return round(time.perf_counter() - t_all, 2), stages


def main():
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    x = (rng.randn(N, D) @ np.diag(np.linspace(3, 0.3, D))).astype(
        np.float32)
    x64 = jnp.asarray(x.astype(np.float64), dtype=jnp.float64)

    runs = []
    for rep in range(REPS):
        p0 = matmul_probe()
        total, stages = run_once(x, x64)
        p1 = matmul_probe()
        clean = max(p0, p1) <= PROBE_MS
        runs.append({"total": total, "stages": stages,
                     "probe_ms": [round(p0, 2), round(p1, 2)],
                     "clean": clean, "warmup": rep == 0})
        print(f"# run {rep}: {total}s probes {p0:.1f}/{p1:.1f}ms "
              f"clean={clean} stages={stages}"
              f"{' (warmup, excluded)' if rep == 0 else ''}", flush=True)

    import statistics
    measured = [r for r in runs if not r["warmup"]]
    n_clean = len([r for r in measured if r["clean"]])
    clean_runs = [r for r in measured if r["clean"]] or measured
    run_label = (f"true median of {n_clean} clean runs, warmup run "
                 f"excluded" if n_clean
                 else f"median of {len(measured)} CONTENDED runs (no clean "
                      f"run this session -- not representative)")
    totals = sorted(r["total"] for r in clean_runs)
    median = round(float(statistics.median(totals)), 2)
    med = min(clean_runs, key=lambda r: abs(r["total"] - median))
    rec = {
        "metric": "knn_50k_balanced_seconds",
        "value": median,
        "unit": (f"s ({N} cells x {D} dims, sight={SIGHT}, k={K}, fully "
                 f"on-device; {run_label}, "
                 f"spread {totals[0]}-{totals[-1]})"),
        "n_clean": n_clean,
        "stages": med["stages"],
        "runs": runs,
        "device": jax.devices()[0].device_kind,
        "note": ("Device-resident end-to-end; run 0 includes "
                 "compilation.  The balance "
                 "scan is the speculative batched while_loop "
                 "(ops/knn_device.py), bit-equal to the host greedy "
                 "loop."),
        "exactness": ("matches exact f64 brute force incl. tie-breaks "
                      "(device f64 re-score; CPU-backend tests "
                      "bit-exact)"),
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
