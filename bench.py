"""Benchmark: neighbor-sampled colDeltaCor (the estimation-stage hot kernel).

This is the kernel behind estimate_transition_prob -- the step the
reference documents as "can take a long time ... fully multithreaded"
(its OpenMP Cython kernel, speedboosted.pyx).  We measure cells/second on
the default JAX device and compare against
the REFERENCE'S OWN COMPILED KERNEL: tests/refkernel builds the generated
C of speedboosted.pyx with the reference's own flags (-fopenmp
-ffast-math, reference setup.py:17-21) and runs it here with the
reference's default thread count (ncpu/2, velocyto/estimation.py:27-30).
If that build is unavailable, a single-thread numpy implementation scaled
by ncpu/2 stands in (flagged in the JSON as baseline="numpy-emulated").

The kernel is bound by the HBM gather of neighbor rows; the JSON also
reports the achieved HBM bandwidth and its fraction of the device's
published peak (roofline fraction).  A device without a published peak
in PEAK_HBM_GBPS is an error: no peak is assumed.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}
"""
import json
import multiprocessing
import os
import sys
import time

import numpy as np

GENES = 2000
CELLS = 3072
NN = 512          # sampled neighbors per cell (reference: n_neighbors * sampled_fraction)
PSC = 1e-10
BASELINE_CELLS = 48

# Published HBM bandwidth by jax device_kind, GB/s.  Source: NVIDIA H100
# Tensor Core GPU data sheet (SXM5 80 GB: 3.35 TB/s; PCIe 80 GB: 2 TB/s).
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
}


def peak_hbm_gbps(device_kind: str) -> float:
    """Published HBM peak of `device_kind`; raises for a device the
    table does not list."""
    try:
        return PEAK_HBM_GBPS[device_kind]
    except KeyError:
        raise ValueError(f"no published HBM peak for device kind "
                         f"{device_kind!r}: add it to PEAK_HBM_GBPS with "
                         f"its source") from None


def reference_kernel_cells_per_sec(e, d, ixs):
    """Measure the reference's own compiled OpenMP kernel (or None)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    try:
        import refkernel
        if not refkernel.available():
            return None
    except Exception:
        return None
    n_meas = min(CELLS, 768)   # subset of center cells: enough for a stable rate
    e_s = np.ascontiguousarray(e[:, :n_meas])
    d_s = np.ascontiguousarray(d[:, :n_meas])
    ixs_s = np.ascontiguousarray(np.minimum(ixs[:n_meas], n_meas - 1),
                                 dtype=np.intp)
    refkernel.col_delta_cor_partial(e_s[:, :64], d_s[:, :64],
                                    np.minimum(ixs_s[:64, :16], 63),
                                    "sqrt", PSC)  # warm
    t0 = time.perf_counter()
    refkernel.col_delta_cor_partial(e_s, d_s, ixs_s, "sqrt", PSC)
    dt = time.perf_counter() - t0
    # per-cell cost is O(G * NN), independent of the total cell count, so
    # the subset rate is the full-size rate
    return n_meas / dt


def numpy_baseline_cells_per_sec(e, d, ixs):
    """Single-thread numpy implementation of the same math (per-cell loop
    with vectorized inner ops, the natural CPU implementation)."""
    n = BASELINE_CELLS
    t0 = time.perf_counter()
    out = np.zeros((n, ixs.shape[1]))
    for c in range(n):
        cols = ixs[c]
        delta = e[:, cols] - e[:, c][:, None]
        a = np.sign(delta) * np.sqrt(np.abs(delta) + PSC)
        a[np.abs(delta) < 1e-16] = 0
        a_c = a - a.mean(0)[None, :]
        b = d[:, c]
        b_c = b - b.mean()
        num = a_c.T @ b_c
        den = np.sqrt((a_c ** 2).sum(0)) * np.sqrt((b_c ** 2).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            out[c] = num / den
    dt = time.perf_counter() - t0
    return n / dt


def main():
    import jax
    from velocyto_tpu.ops.coldeltacor import _partial_impl, _TRANSFORMS

    rng = np.random.RandomState(0)
    e = rng.gamma(2.0, 2.0, size=(GENES, CELLS)).astype(np.float64)
    d = rng.randn(GENES, CELLS).astype(np.float64)
    ixs = np.stack([rng.choice(CELLS, NN, replace=False)
                    for _ in range(CELLS)]).astype(np.int32)

    import jax.numpy as jnp
    e_rows = jnp.asarray(e.T, dtype=jnp.float32)
    d_rows = jnp.asarray(d.T, dtype=jnp.float32)
    ixs_j = jnp.asarray(ixs)
    tcode = _TRANSFORMS["sqrt"]

    def timed(e_src, d_src, ix, reps):
        """Mean seconds per kernel call after one warm (compile) call."""
        jax.block_until_ready(_partial_impl(e_src, e_src, d_src, ix, tcode,
                                            PSC))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = _partial_impl(e_src, e_src, d_src, ix, tcode, PSC)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    dt = timed(e_rows, d_rows, ixs_j, 5)
    dev_cells_per_sec = CELLS / dt

    # same kernel with a 20k-cell (160 MB) gather source, the working-set
    # size of the 20k pipeline's transition stage
    n_big = 20000
    rng_b = np.random.RandomState(1)
    e_big = jnp.asarray(rng_b.gamma(2., 2., (n_big, GENES)).astype(
        np.float32))
    d_big = jnp.asarray(rng_b.randn(n_big, GENES).astype(np.float32))
    ixs_big = jnp.asarray(np.stack(
        [rng_b.choice(n_big, NN, replace=False)
         for _ in range(n_big)]).astype(np.int32))
    dt_big = timed(e_big, d_big, ixs_big, 1)
    big_gbps = n_big * NN * GENES * 4 / dt_big / 1e9

    base = reference_kernel_cells_per_sec(e, d, ixs)
    if base is not None:
        baseline_kind = "reference-openmp"
    else:
        base_st = numpy_baseline_cells_per_sec(e, d, ixs)
        ncpu = multiprocessing.cpu_count()
        base = base_st * max(1, ncpu // 2)  # reference default thread count
        baseline_kind = "numpy-emulated"

    # Roofline: the kernel is bound by the HBM gather of neighbor rows
    # (CELLS * NN * GENES * 4 bytes) + streaming the center rows; its
    # ~8 flops per gathered element are far below the compute roofline.
    bytes_accessed = CELLS * NN * GENES * 4 + 3 * CELLS * GENES * 4
    achieved_gbps = bytes_accessed / dt / 1e9
    dev = jax.devices()[0]
    peak = peak_hbm_gbps(dev.device_kind)

    print(json.dumps({
        "metric": "coldeltacor_sqrt_partial_cells_per_sec",
        "value": round(dev_cells_per_sec, 2),
        "unit": "cells/s (G=2000, nn=512)",
        "vs_baseline": round(dev_cells_per_sec / base, 2),
        "baseline": baseline_kind,
        "baseline_cells_per_sec": round(base, 2),
        "hbm_gbps_achieved": round(achieved_gbps, 1),
        "hbm_roofline_fraction": round(achieved_gbps / peak, 3),
        "large_n_cells_per_sec": round(n_big / dt_big, 1),
        "large_n_gather_gbps": round(big_gbps, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    sys.exit(main())
