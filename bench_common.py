"""Shared contention probes for the bench drivers (bench_attr,
bench_knn50k, bench_pipeline): one small device matmul and one host
dgemm, timed before and after a measured section, so a run whose device
or host cores were shared can be told apart from a clean one.
"""
import time

import numpy as np


def matmul_probe() -> float:
    """D=50 distance-matmul fingerprint in ms (the kNN candidate pass's
    shape class) on the default device."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def prob(a, b):
        return jnp.matmul(a, b.T, precision=jax.lax.Precision.HIGHEST)

    a = jnp.ones((2048, 50), jnp.float32)
    b = jnp.ones((8192, 50), jnp.float32)
    jax.block_until_ready(prob(a, b))   # warm
    t0 = time.perf_counter()
    for _ in range(20):
        out = prob(a, b)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / 20 * 1e3


_HOST_PROBE = {}


def host_probe() -> float:
    """Host BLAS fingerprint (one small dgemm) in ms: host-side stalls
    are invisible to the device probe."""
    a = _HOST_PROBE.setdefault("a", np.random.RandomState(1).randn(512, 512))
    a @ a   # warm
    t0 = time.perf_counter()
    for _ in range(5):
        a @ a
    return (time.perf_counter() - t0) / 5 * 1e3
