"""Smoke tests for the plotting surface (Agg backend): every plot
method must run without error on a small synthetic state."""
import pytest

# matplotlib is optional (see tests/test_knn.py)
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

import velocyto_tpu as vt  # noqa: E402


@pytest.fixture(scope="module")
def vlm():
    rng = np.random.default_rng(0)
    N, G = 60, 30
    base = rng.gamma(2.0, 2.0, (G, N))
    v = vt.VelocytoLoom.__new__(vt.VelocytoLoom)
    v.S = rng.poisson(base).astype(np.float32) + 1
    v.U = rng.poisson(0.4 * base).astype(np.float32)
    v.A = np.zeros_like(v.S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(N)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(G)])}
    v.set_clusters(np.array([f"k{i % 3}" for i in range(N)]))
    v.normalize("both")
    v.perform_PCA(n_components=10)
    v.knn_imputation(k=5, balanced=False, n_jobs=1)
    v.fit_gammas()
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift()
    v.extrapolate_cell_at_t()
    v.ts = np.ascontiguousarray(v.pcs[:, :2])
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                               transform="sqrt", knn_random=False,
                               calculate_randomized=True)
    v.calculate_embedding_shift(expression_scaling=False)
    v.calculate_grid_arrows(steps=(6, 6), n_neighbors=10)
    return v


def _done():
    plt.close("all")


def test_plot_fractions(vlm):
    vlm.plot_fractions()
    _done()


def test_plot_pca(vlm):
    vlm.plot_pca()
    _done()


def test_plot_pca_imputed(vlm):
    vlm.normalize("imputed")
    vlm._perform_PCA_imputed(n_components=5)
    vlm._plot_pca_imputed()
    _done()


def test_plot_phase_portraits(vlm):
    vlm.plot_phase_portraits(["g0", "g1"])
    _done()


def test_plot_grid_arrows(vlm):
    vlm.plot_grid_arrows()
    _done()


def test_plot_arrows_embedding(vlm):
    vlm.plot_arrows_embedding(quiver_scale=1.0)
    _done()


def test_plot_cell_transitions(vlm):
    vlm.plot_cell_transitions(cell_ix=0)
    _done()


def test_plot_velocity_as_color(vlm):
    vlm.plot_velocity_as_color(gene_name="g0")
    _done()


def test_plot_expression_as_color(vlm):
    vlm.plot_expression_as_color(gene_name="g0")
    _done()


def test_scatter_viz(vlm):
    vt.scatter_viz(vlm.ts[:, 0], vlm.ts[:, 1], c=vlm.colorandum)
    _done()
