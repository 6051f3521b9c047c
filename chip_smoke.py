"""Smoke run of the estimation pipeline on one GPU, at the reference's
documented operating point.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the mesh path on four cards

One card: synthesizes 20,000 cells x 2,000 genes of low-rank Poisson
spliced/unspliced counts from a seed, builds a VelocytoLoom from them,
and runs normalize -> PCA(50) -> balanced kNN imputation (k=500,
b_sight=3000, b_maxl=1500) -> gamma fits -> velocity -> sampled
transition probabilities (n_neighbors=3500, sampled_fraction=0.5,
randomized control) -> embedding shift -> grid arrows twice (cold, then
warm), printing a stage table for each.  Then it compares the device
results at that width with float64 references (tests/realwidth.py).

--four-cards: runs the same pipeline with a (4, 1) cells mesh and with
no mesh on one card in the same process, compares them, and compares
the ring-scheduled sampled kernel with the one-card kernel.

The VelocytoLoom is built from arrays, not from a .loom file: loom I/O
needs h5py, which a GPU host need not have.

Exits non-zero, printing no result, when JAX finds no GPU or when any
phase fails.  The last line of a passing run is one JSON object naming
the device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def stage_table(title: str, total: float, stages: dict) -> None:
    log(f"{title}: total {total:.3f} s")
    for name, sec in stages.items():
        log(f"  {name:<18} {sec:9.3f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh comparison")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    devices = jax.devices()
    if args.four_cards and len(devices) != 4:
        print(f"--four-cards needs 4 GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import velocyto_tpu  # noqa: F401  (sets the compile cache)
    from velocyto_tpu import native
    import realwidth as rw

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"jax {jax.__version__}; devices {devices}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    if not native.available():
        raise RuntimeError("native library libvtpu did not build or load")
    when = ("by this process" if native.BUILT_HERE
            else "earlier in this checkout")
    log(f"native library: {native._lib_path()} loaded, built from "
        f"vtpu.cpp {when}")

    p = rw.FULL
    t0 = time.perf_counter()
    S, U = rw.synth(SEED, p["cells"], p["genes"])
    log(f"synthesized {p['cells']} cells x {p['genes']} genes "
        f"in {time.perf_counter() - t0:.3f} s")

    results = []
    if args.four_cards:
        from velocyto_tpu.parallel import make_mesh
        mesh = make_mesh()
        log(f"mesh: {dict(mesh.shape)}")
        tm, sm, vm = rw.run_pipeline(S, U, p, mesh=mesh, log=log)
        stage_table("4-card mesh, cold", tm, sm)
        t1, s1, v1 = rw.run_pipeline(S, U, p, log=log)
        stage_table("1 card, cold", t1, s1)
        tm, sm, vm = rw.run_pipeline(S, U, p, mesh=mesh, log=log)
        stage_table("4-card mesh, warm", tm, sm)
        peaks = [d.memory_stats().get("peak_bytes_in_use") for d in devices]
        log(f"peak device memory per card: {peaks} bytes")
        results += rw.mesh_checks(vm, v1)
        results.append(rw.ring_check(mesh, v1))
    else:
        total, stages, v = rw.run_pipeline(S, U, p, log=log)
        stage_table("cold run (includes compilation)", total, stages)
        total, stages, v = rw.run_pipeline(S, U, p, log=log)
        stage_table("warm run", total, stages)
        peak = devices[0].memory_stats().get("peak_bytes_in_use")
        log(f"peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)")
        results += rw.single_card_checks(v, p)

    for r in results:
        log(rw.format_result(r))
    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        print(f"failed: {failed}", file=sys.stderr)
        return 1
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
