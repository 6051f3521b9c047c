"""How the package meets its host: compile-cache placement, optional
dependencies, the native build, worker processes, precision of device
contractions, the benchmark's peak table and the GPU smoke script's
refusal to run without a GPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _python(code: str, env_update=None, env_drop=(), timeout=240):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.update(env_update or {})
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("preset", [None, "custom"])
def test_compile_cache_placement(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR wins when set; unset, the cache is one
    fixed directory inside the checkout."""
    code = ("import velocyto_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    if preset is None:
        r = _python(code, env_drop=("JAX_COMPILATION_CACHE_DIR",))
        expected = str(REPO / ".jax_cache")
    else:
        expected = str(tmp_path / preset)
        r = _python(code, env_update={"JAX_COMPILATION_CACHE_DIR": expected})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == expected


def test_import_without_optional_dependencies():
    """The package and the estimation path import nothing beyond numpy,
    scipy and jax."""
    code = """
import sys
class Block:
    names = {"h5py", "click", "sklearn", "matplotlib", "pandas"}
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError("blocked " + name)
        return None
sys.meta_path.insert(0, Block())
import velocyto_tpu as vt
import velocyto_tpu.analysis, velocyto_tpu.ops.knn_device
import velocyto_tpu.ops.coldeltacor, velocyto_tpu.diffusion
print("imported", vt.VelocytoLoom.__name__)
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "imported VelocytoLoom" in r.stdout


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py fails, printing no result, when JAX has no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_native_library_builds_once_under_concurrency(tmp_path):
    """Concurrent first use builds the library exactly once, atomically:
    every process loads it and exactly one compiled it."""
    import shutil
    pkg = tmp_path / "velocyto_tpu"
    shutil.copytree(REPO / "velocyto_tpu", pkg,
                    ignore=shutil.ignore_patterns("libvtpu.so*", "*.lock",
                                                  "__pycache__"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from velocyto_tpu import native; "
            "print(native.available(), native.BUILT_HERE)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [o[0].strip().splitlines()[-1] for o in outs]
    assert all(line.startswith("True") for line in lines), lines
    assert sum(line == "True True" for line in lines) == 1, lines
    assert not (pkg / "native" / "libvtpu.so.tmp").exists()


def test_spawned_counting_worker_stays_on_cpu():
    """The initializer of spawned counting workers pins JAX to the CPU
    before any backend starts."""
    code = """
import pickle
import jax
from velocyto_tpu.counting import soa_engine
class Stub: pass
soa_engine.SoaEngine = lambda counter: counter
jax.config.update("jax_platforms", "cuda,cpu")
soa_engine._init_spawned_worker(pickle.dumps(Stub()))
print(jax.config.jax_platforms)
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "cpu"


@pytest.mark.parametrize("which", ["path_integral", "time_evolution"])
def test_diffusion_matmuls_run_at_highest_precision(which):
    """Both diffusion scans lower their dot to HIGHEST precision (true
    float32, never TF32/bf16 matrix-unit passes), and agree with a
    float64 reference."""
    import jax.numpy as jnp
    from velocyto_tpu import diffusion
    fn = {"path_integral": diffusion._path_integral,
          "time_evolution": diffusion._power_steps}[which]
    x = jnp.ones((6,), jnp.float32) / 6
    tr = jnp.eye(6, dtype=jnp.float32)
    text = fn.lower(x, tr, n_steps=3).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots and all("precision = [HIGHEST, HIGHEST]" in ln
                        for ln in dots), dots

    rng = np.random.RandomState(0)
    m = rng.rand(6, 6)
    m /= m.sum(1, keepdims=True)
    x0 = rng.rand(6)
    x0 /= x0.sum()
    out = np.asarray(fn(jnp.asarray(x0, jnp.float32),
                        jnp.asarray(m, jnp.float32), n_steps=4))
    steps = [x0]
    for _ in range(4):
        steps.append(steps[-1] @ m)
    want = sum(steps[1:]) if which == "path_integral" else steps[-1]
    np.testing.assert_allclose(out, want, rtol=1e-5)


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA A100-SXM4-80GB", None),
                                       ("cpu", None)])
def test_bench_peak_table(kind, peak):
    """The benchmark's roofline divides by a published peak of the named
    device; a device the table does not list is an error."""
    sys.path.insert(0, str(REPO))
    import bench
    if peak is None:
        with pytest.raises(ValueError, match="no published HBM peak"):
            bench.peak_hbm_gbps(kind)
    else:
        assert bench.peak_hbm_gbps(kind) == peak
