# %% [markdown]
# # velocyto_tpu analysis walkthrough
#
# A runnable script-notebook port of the reference's DentateGyrus-style
# analysis tutorial (reference doc/tutorial/analysis.rst +
# doc/notebooks/).  The public DentateGyrus loom cannot be downloaded in
# an offline environment, so the walkthrough synthesizes a dataset with
# the same structure the tutorial relies on: a branching differentiation
# trajectory whose unspliced counts lead the spliced counts (real
# velocity signal), plus per-cell cluster labels.
#
# Run it end-to-end:
#     python docs/walkthrough.py          # writes plots to docs/_walkthrough/
# or open it as a notebook (VS Code / jupytext understand `# %%` cells).
#
# Every step is the same method call, in the same order, as the
# reference tutorial.

# %%
import os
import sys

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

# allow running straight from a source checkout (python docs/walkthrough.py)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import velocyto_tpu as vt
from velocyto_tpu.io import loom as loomio

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "_walkthrough")
os.makedirs(OUT, exist_ok=True)


def savefig(name):
    plt.savefig(os.path.join(OUT, name), dpi=110, bbox_inches="tight")
    plt.close("all")
    print(f"wrote {OUT}/{name}")


# %% [markdown]
# ## Synthesize a DentateGyrus-like dataset
#
# 3,000 cells on a branching pseudotime trajectory, 600 genes in four
# kinetic modules.  U is drawn from the *future* of S along the
# trajectory, so the true velocity field points down the branches —
# exactly the structure the real dataset provides and the quantity the
# pipeline is supposed to recover.

# %%
rng = np.random.RandomState(0)
n_cells, n_genes = 3000, 600
t = rng.uniform(0, 1, n_cells)                      # pseudotime
branch = (rng.uniform(size=n_cells) < 0.5).astype(int)
lat = np.stack([np.sin(np.pi * t), t ** 2,
                branch * t, (1 - branch) * t,
                np.cos(2 * np.pi * t) * t], 1)      # (cells, 5)
w = rng.gamma(2.0, 1.0, (5, n_genes)) * \
    rng.uniform(0.2, 1.0, n_genes)[None, :]
gamma_true = rng.uniform(0.2, 1.0, n_genes)
dt = 0.08
t_future = np.clip(t + dt, 0, 1)
lat_f = np.stack([np.sin(np.pi * t_future), t_future ** 2,
                  branch * t_future, (1 - branch) * t_future,
                  np.cos(2 * np.pi * t_future) * t_future], 1)
scales = rng.uniform(0.3, 3.0, n_genes)[None, :]
rate_now = np.exp(lat @ w / 2.5) * scales
rate_future = np.exp(lat_f @ w / 2.5) * scales
S = rng.poisson(rate_now).astype(np.float32)
U = rng.poisson(0.5 * gamma_true[None, :] * rate_future).astype(
    np.float32)
clusters = np.where(t < 0.33, "progenitor",
                    np.where(branch == 1, "branch_A", "branch_B"))

path = os.path.join(OUT, "synthetic_dg.loom")
loomio.create(
    path,
    {"": S.T, "spliced": S.T.astype(np.uint16),
     "unspliced": U.T.astype(np.uint16),
     "ambiguous": np.zeros_like(S.T, dtype=np.uint16)},
    {"Gene": np.array([f"Gene{i}" for i in range(n_genes)]),
     "Accession": np.array([f"ENSG{i:08d}" for i in range(n_genes)])},
    {"CellID": np.array([f"cell:{i:05d}" for i in range(n_cells)]),
     "ClusterName": clusters.astype("U16")},
    {"velocyto.__version__": vt.__version__})
print("loom written:", path)

# %% [markdown]
# ## Load the loom and inspect fractions
# (reference analysis.rst "Velocyto Loom")

# %%
vlm = vt.VelocytoLoom(path)
print("S:", vlm.S.shape, " U:", vlm.U.shape)
vlm.plot_fractions()
savefig("fractions.png")

# %% [markdown]
# ## Preliminary filtering
# (reference analysis.rst "Start a new analysis - Preliminary Filtering")

# %%
vlm.set_clusters(vlm.ca["ClusterName"])
vlm.score_detection_levels(min_expr_counts=30, min_cells_express=15)
vlm.filter_genes(by_detection_levels=True)
vlm.score_cv_vs_mean(max(200, vlm.S.shape[0] // 2), plot=True,
                     max_expr_avg=35)
savefig("cv_vs_mean.png")
vlm.filter_genes(by_cv_vs_mean=True)
print("genes after filtering:", vlm.S.shape[0])

# %%
vlm.normalize("both", size=True, log=True)

# %% [markdown]
# ## Preparation for the gamma fit
# (reference analysis.rst "Preparation for gamma fit": PCA + balanced
# kNN smoothing.  On the device the whole chain from here through the velocity
# extrapolation is device-resident: the (genes, cells) state never
# crosses the host link between stages.)

# %%
vlm.perform_PCA(n_components=25)
plt.plot(np.cumsum(vlm.pca.explained_variance_ratio_)[:25], ".-")
plt.xlabel("PC")
plt.ylabel("cumulative explained variance")
savefig("pca_variance.png")

vlm.knn_imputation(k=60, balanced=True, b_sight=180, b_maxl=120,
                   n_pca_dims=20)

# %% [markdown]
# ## Gamma fit and extrapolation
# (reference analysis.rst "Gamma fit and extrapolation")

# %%
vlm.fit_gammas(limit_gamma=False, fit_offset=True)
corr = np.corrcoef(vlm.gammas, gamma_true[
    np.isin(np.array([f"Gene{i}" for i in range(n_genes)]),
            vlm.ra["Gene"])])[0, 1]
print(f"fitted vs true gamma correlation: {corr:.2f}")

vlm.predict_U()
vlm.calculate_velocity()
vlm.calculate_shift(assumption="constant_velocity")
vlm.extrapolate_cell_at_t(delta_t=1.)

# %%
# phase portrait of the best-fit gene (reference plot_phase_portraits)
best = vlm.ra["Gene"][int(np.nanargmax(vlm.R2))]
vlm.plot_phase_portraits([best])
savefig("phase_portrait.png")

# %% [markdown]
# ## Projection on the embedding
# (reference analysis.rst "Projection of velocity onto embeddings" —
# the tutorial uses TSNE; PCA's first two components keep this
# walkthrough fast and deterministic.  The transition-probability
# kernels, the neighbor sampling replay and the randomized control all
# run exactly as at production scale.)

# %%
vlm.ts = np.ascontiguousarray(vlm.pcs[:, :2])
vlm.estimate_transition_prob(hidim="Sx_sz", embed="ts", transform="sqrt",
                             knn_random=True, n_neighbors=300,
                             sampled_fraction=0.5,
                             calculate_randomized=True)
vlm.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=False)
vlm.calculate_grid_arrows(smooth=0.5, steps=(30, 30), n_neighbors=80)

# %%
vlm.plot_grid_arrows(quiver_scale=1.5)
savefig("grid_arrows.png")

# %%
vlm.plot_arrows_embedding(choice=600, quiver_scale=2.0)
savefig("arrows_embedding.png")

# %% [markdown]
# Sanity check the recovered field: arrows should point down the
# pseudotime gradient (cells move toward later t).

# %%
grad = np.zeros((n_cells, 2))
keep = np.isfinite(vlm.delta_embedding).all(1)
# direction of increasing t in the embedding, estimated per cell from
# its 50 nearest neighbors
from sklearn.neighbors import NearestNeighbors
nn = NearestNeighbors(n_neighbors=50).fit(vlm.ts)
_d, idx = nn.kneighbors(vlm.ts)
for i in range(n_cells):
    dt_ = t[idx[i]] - t[i]
    dxy = vlm.ts[idx[i]] - vlm.ts[i]
    grad[i] = (dxy * dt_[:, None]).mean(0)
gn = np.linalg.norm(grad, axis=1)
dn = np.linalg.norm(vlm.delta_embedding, axis=1)
ok = keep & (gn > 1e-9) & (dn > 1e-9)
cosine = np.einsum("nd,nd->n", grad[ok], vlm.delta_embedding[ok]) / \
    (gn[ok] * dn[ok])
print(f"mean cosine(velocity field, pseudotime gradient): "
      f"{cosine.mean():.2f}  (positive = field tracks the trajectory)")
assert cosine.mean() > 0.1, "field should follow the trajectory"

# %% [markdown]
# ## Markov diffusion on the field
# (reference analysis.rst "Markov process on velocity field" — find the
# terminal regions by diffusing a uniform distribution forward.)

# %%
vlm.prepare_markov(sigma_D=np.median(np.linalg.norm(
    vlm.ts - vlm.ts.mean(0), axis=1)) / 10, sigma_W=0.05,
    direction="forward")
vlm.run_markov(starting_p=np.ones(n_cells), n_steps=1500)
diff = vlm.diffused - np.percentile(vlm.diffused, 3)
diff = np.clip(diff, 0, None) / np.percentile(diff, 97)
plt.scatter(vlm.ts[:, 0], vlm.ts[:, 1], c=np.clip(diff, 0, 1),
            s=6, cmap="viridis")
plt.colorbar(label="diffused endpoint density")
savefig("markov_endpoints.png")
print("endpoint mass at late pseudotime:",
      round(float(t[np.argsort(vlm.diffused)[-300:]].mean()), 2),
      "(dataset mean", round(float(t.mean()), 2), ")")

# %% [markdown]
# ## Save / resume
# (reference analysis.rst "dump_hdf5 / load_velocyto_hdf5")

# %%
snap = os.path.join(OUT, "walkthrough.hdf5")
vlm.to_hdf5(snap)
vlm2 = vt.load_velocyto_hdf5(snap)
np.testing.assert_allclose(vlm2.delta_embedding, vlm.delta_embedding)
print("hdf5 roundtrip ok:", snap)
print("walkthrough complete.")
