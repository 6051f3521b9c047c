"""The pipeline-vs-reference comparisons of chip_smoke.py (realwidth.py).

On the CPU they run at a tiny size; the ``gpu``-marked tests run them at
the reference's operating point (20k cells x 2k genes) on the card:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import numpy as np
import pytest

import realwidth as rw


def _quiet(_msg):
    pass


@pytest.fixture(scope="module")
def tiny_run():
    p = rw.TINY
    S, U = rw.synth(0, p["cells"], p["genes"])
    _total, stages, v = rw.run_pipeline(S, U, p, log=_quiet)
    assert set(stages) >= {"knn_imputation", "transition_prob"}
    return v


@pytest.mark.parametrize("check", ["sampled", "knn", "smooth", "dense"])
def test_single_card_check_tiny(tiny_run, check):
    v, p = tiny_run, rw.TINY
    if check == "sampled":
        r = rw.check_sampled_coldeltacor(v, n_centre=64)
    elif check == "knn":
        r = rw.check_knn_graph(v, p)
    elif check == "smooth":
        r = rw.check_smoothed_sx(v)
    else:
        hi32, d = rw._sampled_inputs(v)
        r, seconds = rw.check_dense_coldeltacor(hi32[:, :96], d[:, :96],
                                                rows=16)
        assert seconds > 0
    assert r["ok"], rw.format_result(r)


def test_compare_flags_mismatch_and_nan():
    """The comparison itself: a tolerance breach or a NaN fails it."""
    want = np.array([1.0, 2.0, 3.0])
    assert rw.compare("same", want * (1 + 1e-7), want, 1e-6)["ok"]
    assert not rw.compare("off", want * 1.01, want, 1e-3)["ok"]
    nan = want.copy()
    nan[1] = np.nan
    assert not rw.compare("nan", nan, want, 1e-3)["ok"]
    assert not rw.compare("shape", want[:2], want, 1e-3)["ok"]


@pytest.mark.parametrize("check", ["mesh", "ring"])
def test_mesh_checks_tiny(tiny_run, check):
    """The four-card comparisons, on 8 virtual CPU devices."""
    from velocyto_tpu.parallel import make_mesh
    p = rw.TINY
    mesh = make_mesh()
    if check == "mesh":
        S, U = rw.synth(0, p["cells"], p["genes"])
        _t, _s, vm = rw.run_pipeline(S, U, p, mesh=mesh, log=_quiet)
        results = rw.mesh_checks(vm, tiny_run)
    else:
        results = [rw.ring_check(mesh, tiny_run)]
    for r in results:
        assert r["ok"], rw.format_result(r)


@pytest.mark.gpu
def test_full_width_on_gpu(gpu):
    """Every one-card comparison at the reference's operating point."""
    p = rw.FULL
    S, U = rw.synth(0, p["cells"], p["genes"])
    _total, _stages, v = rw.run_pipeline(S, U, p, log=_quiet)
    for r in rw.single_card_checks(v, p):
        assert r["ok"], rw.format_result(r)
