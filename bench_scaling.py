"""Scaling harness: sampled colDeltaCor sharded over the cells axis for
increasing device counts (SURVEY.md §7 phase 3).

On several accelerators this measures scaling across them; under
XLA_FLAGS=--xla_force_host_platform_device_count=N it validates the
sharded path's correctness (virtual CPU devices share the same cores,
so the "speedup" column is meaningless there and flagged as such).

Prints one JSON line per device count:
  {"devices": D, "cells_per_sec": X, "efficiency_vs_1": E}
"""
import json
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp
    from velocyto_tpu.ops.coldeltacor import make_partial_sharded
    from velocyto_tpu.parallel.mesh import make_mesh

    G, N, NN = 2000, 4096, 512
    rng = np.random.default_rng(0)
    e = rng.random((G, N), np.float32)
    d = rng.random((G, N), np.float32)
    ixs = np.stack([rng.choice(N, NN, replace=False)
                    for _ in range(N)]).astype(np.int32)
    e_r = jnp.asarray(e.T)
    d_r = jnp.asarray(d.T)
    ixs_r = jnp.asarray(ixs)

    all_devices = jax.devices()
    virtual = all_devices[0].platform == "cpu" and len(all_devices) > 1
    base = None
    counts = [c for c in (1, 2, 4, 8, 16, 32, 64)
              if c <= len(all_devices)]
    for n_dev in counts:
        mesh = make_mesh(devices=all_devices[:n_dev])
        fn = jax.jit(make_partial_sharded(mesh, "sqrt", 1e-10))
        jax.block_until_ready(fn(e_r, e_r, d_r, ixs_r))    # compile
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(e_r, e_r, d_r, ixs_r)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        cps = N / dt
        if base is None:
            base = cps
        rec = {"devices": n_dev, "cells_per_sec": cps,
               "efficiency_vs_1": cps / (base * n_dev),
               "device_kind": all_devices[0].device_kind}
        if virtual:
            rec["note"] = "virtual CPU devices: timing not meaningful"
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
