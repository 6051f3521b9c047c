"""Two-process jax.distributed smoke test (CPU, gloo).

Proves the one layer no other test exercises: collectives CROSSING a
process boundary.  Two subprocesses each own 4 virtual CPU devices of an
8-device mesh and run, across that boundary: the counting-merge psum,
the sharded partial colDeltaCor kernel, the RING-scheduled partial
colDeltaCor (ppermute expression-block rotation -- the collective most
prone to silent regression), and the full sharded velocity step
(GENES x CELLS shardings with cross-axis psum reductions).  Results
must equal the single-process oracles computed in this process.

The workers initialize through parallel/mesh.py initialize_distributed
-- the same entry point a real multi-host deployment uses.

SURVEY.md §5 "Distributed communication backend".
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    env = dict(os.environ)
    # CPU jax in the workers, 4 virtual devices per process
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=4"])
    return env


def test_two_process_collectives(tmp_path):
    port = _free_port()
    env = _worker_env()
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "distributed_worker.py"),
         str(i), "2", str(port), str(outs[i])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    assert all(p.returncode == 0 for p in procs), \
        "\n\n".join(logs)

    results = [json.loads(o.read_text()) for o in outs]
    for r in results:
        assert r["process_count"] == 2
        assert r["n_global_devices"] == 8
        assert r["n_local_devices"] == 4

    # single-process oracle (plain numpy / local kernel)
    rng = np.random.RandomState(0)
    stacked = rng.poisson(1.0, (5, 16, 24)).astype(np.float32)
    expected_merge = stacked.sum(0)

    n, g, nn = 48, 12, 8
    emat = rng.rand(g, n).astype(np.float32)
    dmat = rng.randn(g, n).astype(np.float32)
    ixs = np.stack([rng.choice(n, nn, replace=False)
                    for _ in range(n)]).astype(np.int32)
    from velocyto_tpu.ops.coldeltacor import col_delta_cor_partial_compact
    expected_corr = col_delta_cor_partial_compact(emat, dmat, ixs,
                                                  "sqrt", 1e-10)

    # single-process oracles for the ring kernel and the velocity step
    # (CPU, same f32 arithmetic)
    from velocyto_tpu.models.velocity import velocity_step_jit, example_inputs
    vs_in = example_inputs(g=32, n=64, k=8, nn=16, seed=3)
    vs_out = velocity_step_jit(*vs_in)
    expected_gammas = np.asarray(vs_out.gammas)
    expected_dembed = np.asarray(vs_out.delta_embedding)

    for r in results:
        merged = np.asarray(r["merged"], dtype=np.float32)
        np.testing.assert_array_equal(merged, expected_merge)
        corr = np.asarray(r["corr"], dtype=np.float32)
        np.testing.assert_allclose(corr, expected_corr, rtol=2e-5,
                                   atol=2e-6)
        # ring schedule: ppermute crossed the process boundary on every
        # rotation step; result must match the compact oracle
        ring = np.asarray(r["ring"], dtype=np.float32)
        np.testing.assert_allclose(ring, expected_corr, rtol=2e-5,
                                   atol=2e-6)
        np.testing.assert_allclose(np.asarray(r["vstep_gammas"]),
                                   expected_gammas, rtol=2e-5, atol=2e-6)
        # sigma_corr softmax amplifies the f32 resummation differences
        # of the sharded reductions ~20x (same tolerance class as
        # test_golden_mesh's delta_embedding check)
        np.testing.assert_allclose(
            np.asarray(r["vstep_delta_embedding"]), expected_dembed,
            rtol=1e-3, atol=2e-4)
    # both processes saw the identical global result
    for key in ("corr", "ring", "vstep_gammas", "vstep_delta_embedding"):
        np.testing.assert_array_equal(np.asarray(results[0][key]),
                                      np.asarray(results[1][key]))
