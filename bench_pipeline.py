"""Reference-scale end-to-end estimation benchmark.

Runs the full VelocytoLoom pipeline at the reference's documented
operating point (reference doc/tutorial/analysis.rst:109,163-164:
knn_imputation k=500, b_sight=3000, b_maxl=1500; estimate_transition_prob
n_neighbors=3500, sampled_fraction=0.5) on a synthetic dataset of
VTPU_BENCH_PIPE_CELLS x VTPU_BENCH_PIPE_GENES (default 20000 x 2000),
records per-stage wall times and prints one JSON line.

Measurement policy:
  - run 0 is always a warmup (compilation, first-touch page faults) and
    never enters the statistic;
  - the headline is the median of the clean measured runs (default
    VTPU_BENCH_PIPE_REPS=6 -> 1 warmup + 5 measured), with min/max
    spread alongside;
  - a run is clean when the D=50 matmul probe AND the host-BLAS probe
    bracketing it stay under threshold.

Each stage's wall time is taken after jax.block_until_ready on every
device array the pipeline object holds, so it includes the device work
the stage dispatched.
"""
import json
import os
import time

import numpy as np

CELLS = int(os.environ.get("VTPU_BENCH_PIPE_CELLS", 20000))
GENES = int(os.environ.get("VTPU_BENCH_PIPE_GENES", 2000))
K = int(os.environ.get("VTPU_BENCH_PIPE_K", 500))
B_SIGHT = int(os.environ.get("VTPU_BENCH_PIPE_BSIGHT", 3000))
B_MAXL = int(os.environ.get("VTPU_BENCH_PIPE_BMAXL", 1500))
N_NEIGHBORS = int(os.environ.get("VTPU_BENCH_PIPE_NN", 3500))
SAMPLED_FRACTION = 0.5
RANDOMIZED = os.environ.get("VTPU_BENCH_PIPE_RANDOMIZED", "1") == "1"
REPS = int(os.environ.get("VTPU_BENCH_PIPE_REPS", 6))
PROBE_MS = float(os.environ.get("VTPU_BENCH_PROBE_MS", 8.0))


def synth(rng, n, g):
    gamma_true = rng.uniform(0.2, 1.2, g)
    # low-rank structure so the PCA/kNN stages see realistic manifolds
    k_lat = 12
    zl = rng.gamma(2.0, 1.0, (n, k_lat))
    wl = rng.gamma(2.0, 1.0, (k_lat, g))
    base = (zl @ wl) * rng.uniform(0.05, 0.6, g)[None, :]
    S = rng.poisson(base).astype(np.float32).T
    U = rng.poisson(0.4 * gamma_true[:, None] * base.T + 0.05).astype(
        np.float32)
    return S, U


from bench_common import host_probe, matmul_probe  # noqa: E402


def run_once(S, U, k=K, b_sight=B_SIGHT, b_maxl=B_MAXL,
             n_neighbors=N_NEIGHBORS, randomized=RANDOMIZED, mesh=None,
             log=print):
    """One pass of the pipeline over counts (genes, cells) built into a
    VelocytoLoom from arrays.  Returns (total seconds, {stage: seconds},
    the VelocytoLoom)."""
    import jax
    import velocyto_tpu as vt

    g, n = S.shape
    stages = {}
    t_all = time.perf_counter()
    v = vt.VelocytoLoom.__new__(vt.VelocytoLoom)

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(list(v.__dict__.values()))
        dt = time.perf_counter() - t0
        stages[name] = dt
        log(f"# {name}: {dt:.3f}s")
        return out

    v.mesh = mesh
    v.S, v.U, v.A = S.copy(), U.copy(), np.zeros_like(S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(n)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(g)])}

    def _norm():
        # _normalize_S(log=True) computes S_norm = log2(S_sz + 1) itself
        v._normalize_S(relative_size=v.initial_cell_size,
                       target_size=np.mean(v.initial_cell_size))
        v._normalize_U(relative_size=v.initial_Ucell_size,
                       target_size=np.mean(v.initial_Ucell_size))
    stage("normalize", _norm)
    stage("pca", lambda: v.perform_PCA(which="S_norm", n_components=50))
    stage("knn_imputation", lambda: v.knn_imputation(
        k=k, balanced=True, b_sight=b_sight, b_maxl=b_maxl, n_jobs=16))
    stage("fit_gammas", lambda: v.fit_gammas())

    def _vel():
        v.predict_U()
        v.calculate_velocity()
        v.calculate_shift(assumption="constant_velocity")
        v.extrapolate_cell_at_t(delta_t=1.)
    stage("velocity", _vel)
    v.ts = np.ascontiguousarray(v.pcs[:, :2])
    stage("transition_prob", lambda: v.estimate_transition_prob(
        hidim="Sx_sz", embed="ts", transform="sqrt", knn_random=True,
        n_neighbors=n_neighbors, sampled_fraction=SAMPLED_FRACTION,
        calculate_randomized=randomized))
    stage("embedding_shift",
          lambda: v.calculate_embedding_shift(sigma_corr=0.05,
                                              expression_scaling=False))
    stage("grid_arrows",
          lambda: v.calculate_grid_arrows(smooth=0.5, steps=(40, 40),
                                          n_neighbors=100))
    total = time.perf_counter() - t_all
    if not np.all(np.isfinite(v.delta_embedding)):
        raise FloatingPointError("non-finite delta_embedding")
    return total, stages, v


def main():
    import jax

    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    S, U = synth(rng, CELLS, GENES)
    synth_s = round(time.perf_counter() - t0, 2)
    print(f"# synthesize: {synth_s}s", flush=True)

    host_ms = float(os.environ.get("VTPU_BENCH_HOST_PROBE_MS", 18.0))
    runs = []
    for rep in range(REPS):
        p_before, h_before = matmul_probe(), host_probe()
        total, stages, _ = run_once(S, U)
        p_after, h_after = matmul_probe(), host_probe()
        clean = max(p_before, p_after) <= PROBE_MS and \
            max(h_before, h_after) <= host_ms
        runs.append({"total": total, "stages": stages,
                     "probe_ms": [round(p_before, 2), round(p_after, 2)],
                     "host_probe_ms": [round(h_before, 1),
                                       round(h_after, 1)],
                     "clean": clean,
                     "warmup": rep == 0})
        print(f"# run {rep}: {total:.1f}s probes "
              f"{p_before:.1f}/{p_after:.1f}ms host "
              f"{h_before:.0f}/{h_after:.0f}ms clean={clean}"
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
    median = float(statistics.median(totals))
    med_run = min(clean_runs, key=lambda r: abs(r["total"] - median))
    result = {
        "metric": "pipeline_seconds_end_to_end",
        "value": median,
        "unit": f"s ({CELLS} cells x {GENES} genes, k={K}, "
                f"b_sight={B_SIGHT}, nn={N_NEIGHBORS}; {run_label}, "
                f"spread {totals[0]}-{totals[-1]})",
        "backend": jax.default_backend(),
        "device": jax.devices()[0].device_kind,
        "stages": med_run["stages"],
        "synthesize_fixture_seconds": synth_s,
        "runs": runs,
        "min_total": totals[0],
        "max_total": totals[-1],
        "n_clean": n_clean,
        "cells_per_sec_end_to_end": CELLS / median,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
