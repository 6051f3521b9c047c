"""VelocytoLoom: the post-counting analysis pipeline.

API-parity re-implementation of the reference's analysis object
(reference: velocyto/analysis.py:26-2470), with every hot numerical path
routed through the device kernels in velocyto_tpu.ops:

  - PCA                -> ops.pca (host LAPACK Gram-eigh / SVD)
  - kNN + balancing    -> ops.knn_device (blocked matmul distances, f64
                          re-score, batched greedy balance scan)
  - smoothing          -> ops.knn_device (blocked scatter-to-dense matmul)
  - gamma fits         -> ops.gamma (vmapped closed-form constrained QP)
  - transition probs   -> ops.coldeltacor (blocked XLA)
  - embedding shift    -> blocked jitted XLA (this module)

sklearn is kept only where the reference itself delegates to it and the
computation is cold (SVR noise model, TSNE).
"""
from __future__ import annotations

import logging
import warnings
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import functools

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse
from scipy.spatial.distance import pdist, squareform
from scipy.stats import norm as normal

from .io import loom as loomio
from .ops.pca import PCA
from .ops.knn import (BalancedKNN, knn_distance_matrix, knn_search,
                      make_mutual, take_top)
from .ops.smoothing import connectivity_to_weights, convolve_by_sparse_weights
from .ops.gamma import (fit_slope, fit_slope_offset, fit_slope_weighted,
                        fit_slope_weighted_offset, clusters_stats)
from .ops.coldeltacor import (col_delta_cor, col_delta_cor_partial)
from .diffusion import Diffusion
from .serialization import dump_hdf5, load_hdf5


def _scaled_pair(M: np.ndarray, factor: Any, pcount: float, want_log: bool,
                 clean_nonfinite: bool = False
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``factor * M`` and optionally ``log2(factor * M + pcount)`` with
    out= ufuncs into freshly-requested buffers: no broadcast temporaries,
    so with the package's malloc tuning every buffer after the first
    pipeline pass is a recycled heap block instead of a fresh mmap
    paying first-touch page faults (this family measured 13 s of the 50k
    pipeline as naive expressions; ~0.5 s steady-state this way).

    Bit-exact to the naive expressions: dtypes come from 1-element
    probes of the actual operands, and per-element op order is
    unchanged (multiply; optional nonfinite-to-zero; add; log2)."""
    f_probe = factor if np.isscalar(factor) else np.ravel(factor)[:1]
    m_probe = np.ravel(M)[:1]
    with np.errstate(divide="ignore", invalid="ignore"):
        sz_probe = f_probe * m_probe
        sz = np.empty(M.shape, sz_probe.dtype)
        np.multiply(factor, M, out=sz, casting="unsafe")
        if clean_nonfinite and sz.dtype.kind == "f":
            np.nan_to_num(sz, copy=False, nan=0.0, posinf=0.0, neginf=0.0)
        norm = None
        if want_log:
            log_probe = np.log2(sz_probe + pcount)
            norm = np.empty(M.shape, log_probe.dtype)
            np.add(sz, pcount, out=norm, casting="unsafe")
            np.log2(norm, out=norm)
    return sz, norm


def _plt():
    import matplotlib.pyplot as plt
    return plt


class VelocytoLoom:
    """In-memory analysis object for a velocyto loom file.

    Attribute-accretion API matching the reference (analysis.py:26-94):
    methods return None and create attributes (S, U, A, S_sz, Sx, gammas,
    velocity, delta_embedding, ...).
    """

    def __init__(self, loom_filepath: str, mesh=None) -> None:
        """mesh: optional jax.sharding.Mesh (see parallel.make_mesh).
        When given, the heavy pipeline stages (kNN search,
        colDeltaCor, embedding shift) shard cells over the mesh CELLS
        axis and scale across all chips; results are identical to the
        single-device path."""
        self.loom_filepath = loom_filepath
        self.mesh = mesh
        ds = loomio.connect(self.loom_filepath)
        self.S = ds.layer["spliced"][:, :]
        self.U = ds.layer["unspliced"][:, :]
        self.A = ds.layer["ambiguous"][:, :]
        self.ca = dict(ds.col_attrs.items())
        self.ra = dict(ds.row_attrs.items())
        ds.close()

        self.initial_cell_size = self.S.sum(0)
        self.initial_Ucell_size = self.U.sum(0)

        try:
            if np.mean(self.ca["_Valid"]) < 1:
                logging.warning(
                    f"fraction of _Valid cells is {np.mean(self.ca['_Valid'])} "
                    "but all will be taken in consideration")
        except KeyError:
            pass

    # ------------------------------------------------------------------
    # device-resident pipeline state
    # ------------------------------------------------------------------
    #
    # The heavy (genes, cells) stage outputs (Sx, Ux, Sx_sz, Ux_sz,
    # Upred, velocity, delta_S, ...) live on device as f32 arrays in
    # self._dev_state; downstream device stages consume them directly
    # (no host round-trip between pipeline stages), and the public
    # numpy attribute the reference exposes is materialized lazily on
    # first read (cached in _dev_host_cache).  An explicit assignment
    # to the attribute makes the host value authoritative again (the
    # device entry is dropped), so reference-style workflows that
    # overwrite e.g. vlm.Sx_sz keep working.  NOTE: in-place mutation
    # of a lazily-materialized view (vlm.Sx_sz[...] = 0) does not
    # propagate back to the device copy; assign the attribute instead.

    def __setattr__(self, name: str, value: Any) -> None:
        ds = self.__dict__.get("_dev_state")
        if ds is not None and name in ds:
            del ds[name]
            self.__dict__.get("_dev_host_cache", {}).pop(name, None)
        recipes = self.__dict__.get("_dev_recipes")
        if recipes:
            recipes.pop(name, None)                 # target reassigned
            for k in [k for k, (src, _f, _c) in recipes.items()
                      if src == name]:
                del recipes[k]                      # source reassigned
        object.__setattr__(self, name, value)

    def _set_dev(self, name: str, dev) -> None:
        """Store a device array as the authoritative value of `name`."""
        self.__dict__.pop(name, None)
        self.__dict__.setdefault("_dev_state", {})[name] = dev
        self.__dict__.setdefault("_dev_host_cache", {}).pop(name, None)

    def _set_dev_recipe(self, name: str, src: str, factor,
                        clean: bool) -> None:
        """Register `name` as device-computable: factor * <src> (with
        optional nonfinite-to-zero cleanup), so _get_dev can upload the
        RAW source instead of the scaled matrix.  Raw counts that are
        exact in uint16 upload at half the f32 bytes, and the on-device
        f32 multiply is bit-identical to the host one."""
        self.__dict__.setdefault("_dev_recipes", {})[name] = \
            (src, factor, clean)

    def _get_dev(self, name: str):
        """Device f32 view of attribute `name` (no transfer when the
        attribute is device-backed; computed from the raw source when a
        scale recipe exists; upload otherwise)."""
        ds = self.__dict__.get("_dev_state")
        if ds is not None and name in ds:
            return ds[name]
        recipe = (self.__dict__.get("_dev_recipes") or {}).get(name)
        if recipe is not None:
            src, factor, clean = recipe
            raw = getattr(self, src)
            raw_dt = raw
            if raw.dtype.kind == "f" and raw.size:
                # counts stored as floats: uint16 halves the payload
                # again when exact (integral, < 65536)
                mx = raw.max() if raw.size else 0
                if mx < 65536 and not np.any(raw != np.floor(raw)):
                    raw_dt = raw.astype(np.uint16)
            dev = jnp.asarray(raw_dt).astype(jnp.float32) * \
                jnp.asarray(np.asarray(factor, np.float32))
            if clean:
                dev = jnp.where(jnp.isfinite(dev), dev, jnp.float32(0))
            return dev
        return jnp.asarray(getattr(self, name), jnp.float32)

    def _materialize_dev(self, name: str) -> np.ndarray:
        dev = self.__dict__["_dev_state"][name]
        cache = self.__dict__.setdefault("_dev_host_cache", {})
        if name not in cache:
            cache[name] = np.array(dev, dtype=np.float64)
        return cache[name]

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------

    def to_hdf5(self, filename: str, **kwargs: Any) -> None:
        """Snapshot every attribute to hdf5 (resume with
        load_velocyto_hdf5).  The device mesh and the on-device compact
        correlation handles are runtime state, not data: lazy dense
        views (corrcoef / transition_prob) are materialized first so the
        snapshot matches the reference's attribute set, then the device
        handles are dropped from the dump."""
        for name in VelocytoLoom._LAZY_DENSE:
            try:
                getattr(self, name)
            except AttributeError:
                pass
        # device-backed attributes: materialize the host copy into
        # __dict__ so the snapshot carries the reference attribute set
        for name in list(self.__dict__.get("_dev_state", ())):
            self.__dict__[name] = self._materialize_dev(name)
        if self.__dict__.get("_knn_graph_dev") is not None:
            self.knn_smoothing_w   # noqa: B018 - forces knn materialization
            self.knn
        if self.__dict__.get("_compact_ixs_dev") is not None:
            self.embedding_knn
            self._compact_ixs
        mesh = self.__dict__.pop("mesh", None)
        dev = {k: self.__dict__.pop(k)
               for k in ("_corr_dev", "_corr_rndm_dev", "_dev_state",
                         "_dev_host_cache", "_knn_graph_dev",
                         "_compact_ixs_dev", "_dev_recipes")
               if k in self.__dict__}
        try:
            dump_hdf5(self, filename, **kwargs)
        finally:
            self.mesh = mesh
            self.__dict__.update(dev)

    # ------------------------------------------------------------------
    # cell/gene bookkeeping
    # ------------------------------------------------------------------

    def filter_cells(self, bool_array: np.ndarray) -> None:
        """Keep only cells where bool_array is True (reference :137-165)."""
        self.S, self.U, self.A = (X[:, bool_array]
                                  for X in (self.S, self.U, self.A))
        self.initial_cell_size = self.initial_cell_size[bool_array]
        self.initial_Ucell_size = self.initial_Ucell_size[bool_array]
        for attr in ("ts", "size_factor"):
            try:
                setattr(self, attr, getattr(self, attr)[bool_array])
            except AttributeError:
                pass
        self.ca = {k: v[bool_array] for k, v in self.ca.items()}
        try:
            self.cluster_labels = self.cluster_labels[bool_array]
            self.colorandum = self.colorandum[bool_array, :]
        except AttributeError:
            pass

    def set_clusters(self, cluster_labels: np.ndarray,
                     cluster_colors_dict: Optional[Dict[str, List[float]]] = None,
                     colormap: Any = None) -> None:
        """Set cluster labels + colors (reference :167-201)."""
        self.cluster_labels = np.array(cluster_labels)
        if self.cluster_labels.dtype == "O":
            self.cluster_labels = self.cluster_labels.astype(np.bytes_)
        if cluster_colors_dict:
            self.colorandum = np.array([cluster_colors_dict[i]
                                        for i in cluster_labels])
            self.cluster_colors_dict = cluster_colors_dict
            self.colormap = None
        else:
            if colormap is None:
                self.colorandum = colormap_fun(self.cluster_ix)
                cluster_uid = self.cluster_uid
                self.cluster_colors_dict = {
                    cluster_uid[i]: colormap_fun(np.array([i]))[0]
                    for i in range(len(cluster_uid))}
            else:
                self.colormap = colormap
                self.colorandum = self.colormap(self.cluster_ix)
                cluster_uid = self.cluster_uid
                self.cluster_colors_dict = {
                    cluster_uid[i]: self.colormap(i)
                    for i in range(len(cluster_uid))}

    @property
    def cluster_uid(self) -> np.ndarray:
        return np.unique(self.cluster_labels)

    @property
    def cluster_ix(self) -> np.ndarray:
        _, cluster_ix = np.unique(self.cluster_labels, return_inverse=True)
        return cluster_ix

    # ------------------------------------------------------------------
    # gene scoring / filtering
    # ------------------------------------------------------------------

    def score_cv_vs_mean(self, N: int = 3000, min_expr_cells: int = 2,
                         max_expr_avg: float = 20, min_expr_avg: int = 0,
                         svr_gamma: Optional[float] = None,
                         winsorize: bool = False,
                         winsor_perc: Tuple[float, float] = (1, 99.5),
                         sort_inverse: bool = False, which: str = "S",
                         plot: bool = False) -> None:
        """CV-vs-mean SVR noise model ranking (reference :213-342).

        The SVR is sklearn's (cold path, identical to the reference);
        moment computation is numpy.
        """
        from sklearn.svm import SVR
        M = self.S if which == "S" else self.U
        if winsorize:
            if min_expr_cells <= ((100 - winsor_perc[1]) * M.shape[1] * 0.01):
                min_expr_cells = int(np.ceil(
                    (100 - winsor_perc[1]) * M.shape[0] * 0.01)) + 2

        detected_bool = ((M > 0).sum(1) > min_expr_cells) & \
                        (M.mean(1) < max_expr_avg) & (M.mean(1) > min_expr_avg)
        Mf = M[detected_bool, :]
        if winsorize:
            down, up = np.percentile(Mf, winsor_perc, 1)
            Mfw = np.clip(Mf, down[:, None], up[:, None])
            mu = Mfw.mean(1)
            sigma = Mfw.std(1, ddof=1)
        else:
            mu = Mf.mean(1)
            sigma = Mf.std(1, ddof=1)

        cv = sigma / mu
        log_m = np.log2(mu)
        log_cv = np.log2(cv)

        if svr_gamma is None:
            svr_gamma = 150.0 / len(mu)
        clf = SVR(gamma=svr_gamma)
        clf.fit(log_m[:, None], log_cv)
        ff = clf.predict(log_m[:, None])
        score = log_cv - ff
        if sort_inverse:
            score = -score
        nth_score = np.sort(score)[::-1][N] if N < len(score) else np.min(score) - 1e-16
        if plot:
            plt = _plt()
            scatter_viz(log_m[score > nth_score], log_cv[score > nth_score],
                        s=3, alpha=0.4, c="tab:red")
            scatter_viz(log_m[score <= nth_score], log_cv[score <= nth_score],
                        s=3, alpha=0.4, c="tab:blue")
            mu_linspace = np.linspace(np.min(log_m), np.max(log_m))
            plt.plot(mu_linspace, clf.predict(mu_linspace[:, None]), c="k")
            plt.xlabel(f"log2 mean {which}")
            plt.ylabel(f"log2 CV {which}")
        full_score = np.zeros(detected_bool.shape)
        full_score[~detected_bool] = np.min(score) - 1e-16
        full_score[detected_bool] = score
        if which == "S":
            self.cv_mean_score = full_score
            self.cv_mean_selected = self.cv_mean_score >= nth_score
        else:
            self.Ucv_mean_score = full_score
            self.Ucv_mean_selected = self.Ucv_mean_score >= nth_score

    def robust_size_factor(self, pc: float = 0.1, which: str = "both") -> None:
        """Anders-Huber style size factors (reference :344-382)."""
        def _sf(M, sel):
            Y = np.log2(M[sel, :] + pc)
            Y_avg = Y.mean(1)
            sf = np.median(2 ** (Y - Y_avg[:, None]), axis=0)
            return sf / np.mean(sf)
        if which in ("both", "S"):
            self.size_factor = _sf(self.S, self.cv_mean_selected)
        if which in ("both", "U"):
            self.Usize_factor = _sf(self.U, self.Ucv_mean_selected)

    def score_cluster_expression(self, min_avg_U: float = 0.02,
                                 min_avg_S: float = 0.08) -> None:
        """Cluster-wise expression threshold (reference :384-403)."""
        self.U_avgs, self.S_avgs = clusters_stats(
            self.U, self.S, self.cluster_uid, self.cluster_ix, size_limit=40)
        self.clu_avg_selected = (self.U_avgs.max(1) > min_avg_U) & \
                                (self.S_avgs.max(1) > min_avg_S)

    def score_detection_levels(self, min_expr_counts: int = 50,
                               min_cells_express: int = 20,
                               min_expr_counts_U: int = 0,
                               min_cells_express_U: int = 0) -> None:
        """Detection-level gene filter scores (reference :405-432)."""
        S_sum = self.S.sum(1)
        S_ncells = (self.S > 0).sum(1)
        U_sum = self.U.sum(1)
        U_ncells = (self.U > 0).sum(1)
        self.detection_level_selected = (
            (S_sum >= min_expr_counts) & (S_ncells >= min_cells_express) &
            (U_sum >= min_expr_counts_U) & (U_ncells >= min_cells_express_U))

    def filter_genes(self, by_detection_levels: bool = False,
                     by_cluster_expression: bool = False,
                     by_cv_vs_mean: bool = False,
                     by_custom_array: Any = None,
                     keep_unfiltered: bool = False) -> None:
        """Apply gene filters to S/U/ra (reference :434-496)."""
        assert np.any([by_detection_levels, by_cluster_expression,
                       by_cv_vs_mean, type(by_custom_array) is np.ndarray]), \
            "At least one of the filtering methods needs to be True"
        tmp_filter = np.ones(self.S.shape[0], dtype=bool)
        if by_cluster_expression:
            tmp_filter = tmp_filter & self.clu_avg_selected
        if by_cv_vs_mean:
            tmp_filter = tmp_filter & self.cv_mean_selected
        if by_detection_levels:
            tmp_filter = tmp_filter & self.detection_level_selected
        if type(by_custom_array) is np.ndarray:
            if by_custom_array.dtype == bool:
                tmp_filter = tmp_filter & by_custom_array
            else:
                bool_negative = ~np.isin(np.arange(len(tmp_filter)),
                                         by_custom_array)
                tmp_filter[bool_negative] = False
        if keep_unfiltered:
            self.U_prefilter = sparse.csr_matrix(self.U)
            self.S_prefilter = sparse.csr_matrix(self.S)
            self.ra_prefilter = deepcopy(self.ra)
        self.U = self.U[tmp_filter, :]
        self.S = self.S[tmp_filter, :]
        self.ra = {k: v[tmp_filter] for k, v in self.ra.items()}

    def custom_filter_attributes(self, attr_names: List[str],
                                 bool_filter: np.ndarray) -> None:
        """Filter arbitrary attributes (reference :498-533).  A ".T"
        suffix filters a 2-D array along its LAST axis instead of the
        first; dicts are filtered value-wise."""
        for spec in attr_names:
            last_axis = spec.endswith(".T")
            name = spec[:-2] if last_axis else spec
            obj = getattr(self, name)
            if type(obj) is dict:
                kept = {k: v[bool_filter] for k, v in obj.items()}
            elif type(obj) is np.ndarray:
                if obj.ndim > 1 and last_axis:
                    kept = obj[..., bool_filter]
                elif obj.ndim > 1:
                    kept = obj[bool_filter, :]
                else:
                    kept = obj[bool_filter]
            else:
                raise NotImplementedError(
                    f"The filtering of an object of type {type(obj)} "
                    "is not defined")
            setattr(self, name, kept)

    # ------------------------------------------------------------------
    # normalization family (reference :535-904)
    # ------------------------------------------------------------------

    def _normalize_S(self, size: bool = True, log: bool = True,
                     pcount: float = 1, relative_size: Any = None,
                     target_size: Any = None) -> None:
        if size:
            if type(relative_size) is np.ndarray:
                self.cell_size = relative_size
            else:
                self.cell_size = self.S.sum(0)
            self.avg_size = (self.cell_size.mean()
                             if target_size is None else target_size)
            self.norm_factor = self.avg_size / self.cell_size
        else:
            self.norm_factor = 1
        self.S_sz, s_norm = _scaled_pair(self.S, self.norm_factor,
                                         pcount, log)
        if self.S_sz.dtype in (np.float32, np.float64):
            # device consumers can then upload the raw (compressible)
            # counts instead of this scaled matrix.  For f32 host
            # results the on-device factor*S is bit-identical; for f64
            # the f32(factor)*f32(S) product differs from rounding the
            # f64 product by at most 1 ulp -- the device path is f32
            # everywhere regardless
            self._set_dev_recipe("S_sz", "S", self.norm_factor, False)
        if log:
            self.S_norm = s_norm

    def _normalize_U(self, size: bool = True, log: bool = True,
                     pcount: float = 1, use_S_size: bool = False,
                     relative_size: Any = None, target_size: Any = None) -> None:
        if size:
            if use_S_size:
                cell_size = (self.cell_size if hasattr(self, "cell_size")
                             else self.S.sum(0))
            elif type(relative_size) is np.ndarray:
                cell_size = relative_size
            else:
                cell_size = self.U.sum(0)
            self.Ucell_size = cell_size
            avg_size = cell_size.mean() if target_size is None else target_size
            self.Uavg_size = avg_size
            with np.errstate(divide="ignore", invalid="ignore"):
                norm_factor = avg_size / cell_size
        else:
            norm_factor = 1
        self.Unorm_factor = norm_factor
        self.U_sz, u_norm = _scaled_pair(self.U, norm_factor, pcount, log,
                                         clean_nonfinite=True)
        if self.U_sz.dtype in (np.float32, np.float64):
            self._set_dev_recipe("U_sz", "U", norm_factor, True)
        if log:
            self.U_norm = u_norm

    def _normalize_Sx(self, size: bool = True, log: bool = True,
                      pcount: float = 1, relative_size: Any = None,
                      target_size: Any = None) -> None:
        if size:
            if relative_size is not None and np.any(relative_size):
                self.xcell_size = relative_size
            else:
                self.xcell_size = self.Sx.sum(0)
            self.xavg_size = (self.xcell_size.mean()
                              if target_size is None else target_size)
            self.xnorm_factor = self.xavg_size / self.xcell_size
        else:
            self.xnorm_factor = 1
        self.Sx_sz, sx_norm = _scaled_pair(self.Sx, self.xnorm_factor,
                                           pcount, log)
        if log:
            self.Sx_norm = sx_norm

    def _normalize_Ux(self, size: bool = True, log: bool = True,
                      pcount: float = 1, use_Sx_size: bool = False,
                      relative_size: Any = None, target_size: Any = None) -> None:
        if size:
            if use_Sx_size:
                cell_size = (self.xcell_size if hasattr(self, "cell_size")
                             else self.Sx.sum(0))
            elif type(relative_size) is np.ndarray:
                cell_size = relative_size
            else:
                cell_size = self.Ux.sum(0)
            self.xUcell_size = cell_size
            avg_size = cell_size.mean() if target_size is None else target_size
            self.xUavg_size = avg_size
            with np.errstate(divide="ignore", invalid="ignore"):
                norm_factor = avg_size / cell_size
        else:
            norm_factor = 1
        self.xUnorm_factor = norm_factor
        self.Ux_sz, ux_norm = _scaled_pair(self.Ux, norm_factor, pcount,
                                           log, clean_nonfinite=True)
        if log:
            self.Ux_norm = ux_norm

    def normalize(self, which: str = "both", size: bool = True,
                  log: bool = True, pcount: float = 1,
                  relative_size: Optional[np.ndarray] = None,
                  use_S_size_for_U: bool = False,
                  target_size: Tuple[Any, Any] = (None, None)) -> None:
        """Normalization facade (reference :633-676)."""
        if which == "both":
            self._normalize_S(size=size, log=log, pcount=pcount,
                              relative_size=relative_size,
                              target_size=target_size[0])
            self._normalize_U(size=size, log=log, pcount=pcount,
                              use_S_size=use_S_size_for_U,
                              relative_size=relative_size,
                              target_size=target_size[1])
        if which == "S":
            self._normalize_S(size=size, log=log, pcount=pcount,
                              relative_size=relative_size,
                              target_size=target_size[0])
        if which == "U":
            self._normalize_U(size=size, log=log, pcount=pcount,
                              use_S_size=use_S_size_for_U,
                              relative_size=relative_size,
                              target_size=target_size[1])
        if which == "imputed":
            self._normalize_Sx(size=size, log=log, pcount=pcount,
                               relative_size=relative_size,
                               target_size=target_size[0])
            self._normalize_Ux(size=size, log=log, pcount=pcount,
                               use_Sx_size=use_S_size_for_U,
                               relative_size=relative_size,
                               target_size=target_size[1])
        if which == "Sx":
            self._normalize_Sx(size=size, log=log, pcount=pcount,
                               relative_size=relative_size,
                               target_size=target_size[0])
        if which == "Ux":
            self._normalize_Ux(size=size, log=log, pcount=pcount,
                               use_Sx_size=use_S_size_for_U,
                               relative_size=relative_size,
                               target_size=target_size[1])

    def normalize_by_total(self, min_perc_U: float = 0.5, plot: bool = False,
                           skip_low_U_pop: bool = True,
                           same_size_UnS: bool = False) -> None:
        """Size-normalize by the initial totals (reference :704-758)."""
        target_cell_size = np.median(self.initial_cell_size)
        min_Ucell_size = np.percentile(self.initial_Ucell_size, min_perc_U)
        if min_Ucell_size < 2:
            raise ValueError(
                f"min_perc_U={min_perc_U} corresponds to total Unspliced of "
                "1 molecule of less. Please choose higher value or filter "
                "our these cell")
        self.small_U_pop = self.initial_Ucell_size < min_Ucell_size
        if same_size_UnS:
            target_Ucell_size = target_cell_size
        else:
            target_Ucell_size = np.median(
                self.initial_Ucell_size[~self.small_U_pop])
        self._normalize_S(relative_size=self.initial_cell_size,
                          target_size=target_cell_size)
        if skip_low_U_pop:
            self._normalize_U(
                relative_size=np.clip(self.initial_Ucell_size,
                                      min_Ucell_size, None),
                target_size=target_Ucell_size)
        else:
            self._normalize_U(relative_size=self.initial_Ucell_size,
                              target_size=target_Ucell_size)

    def normalize_by_size_factor(self, min_perc_U: float = 0.5,
                                 plot: bool = False,
                                 skip_low_U_pop: bool = True,
                                 same_size_UnS: bool = False) -> None:
        """Size-normalize by robust size factors (reference :760-815)."""
        cell_size = self.S.sum(0)
        Ucell_size = self.U.sum(0)
        target_cell_size = np.median(cell_size)
        min_Ucell_size = np.percentile(Ucell_size, min_perc_U)
        if min_Ucell_size < 2:
            raise ValueError(
                f"min_perc_U={min_perc_U} corresponds to total Unspliced of "
                "1 molecule of less. Please choose higher value or filter "
                "our these cell")
        self.small_U_pop = Ucell_size < min_Ucell_size
        if same_size_UnS:
            target_Ucell_size = target_cell_size
        else:
            target_Ucell_size = np.median(Ucell_size[~self.small_U_pop])
        self._normalize_S(relative_size=self.size_factor,
                          target_size=target_cell_size)
        if skip_low_U_pop:
            self._normalize_U(
                relative_size=np.clip(self.initial_Ucell_size,
                                      min_Ucell_size, None),
                target_size=target_Ucell_size)
        else:
            self._normalize_U(relative_size=self.initial_Ucell_size,
                              target_size=target_Ucell_size)

    def adjust_totS_totU(self, skip_low_U_pop: bool = True,
                         normalize_total: bool = False,
                         fit_with_low_U: bool = True,
                         svr_C: float = 100, svr_gamma: float = 1e-6,
                         plot: bool = False) -> None:
        """SVR-based U rescaling vs S totals (reference :817-867)."""
        from sklearn.svm import SVR
        svr = SVR(C=svr_C, kernel="rbf", gamma=svr_gamma)
        X, y = self.S_sz.sum(0), self.U_sz.sum(0)
        if fit_with_low_U:
            svr.fit(X[:, None], y)
            predicted = svr.predict(X[:, None])
        else:
            svr.fit(X[~self.small_U_pop, None], y[~self.small_U_pop])
            predicted = np.copy(y)
            predicted[~self.small_U_pop] = svr.predict(
                X[~self.small_U_pop, None])
        adj_factor = predicted / y
        adj_factor[~np.isfinite(adj_factor)] = 1
        if skip_low_U_pop:
            # in-place mutation bypasses __setattr__: drop the raw-scale
            # device recipe so _get_dev sees the adjusted values
            (self.__dict__.get("_dev_recipes") or {}).pop("U_sz", None)
            self.U_sz[:, ~self.small_U_pop] = \
                self.U_sz[:, ~self.small_U_pop] * adj_factor[~self.small_U_pop]
        else:
            self.U_sz = self.U_sz * adj_factor
        if normalize_total:
            self.normalize_median(which="renormalize",
                                  skip_low_U_pop=skip_low_U_pop)

    def normalize_median(self, which: str = "imputed",
                         skip_low_U_pop: bool = True) -> None:
        """Median renormalization (reference :869-904)."""
        if not hasattr(self, "small_U_pop") and skip_low_U_pop:
            self.small_U_pop = np.zeros(self.U_sz.shape[1], dtype=bool)
        if which == "renormalize":
            sums = self.S_sz.sum(0)
            self.S_sz, _ = _scaled_pair(self.S_sz, np.median(sums) / sums,
                                        0, False)
            if skip_low_U_pop:
                # in-place mutation bypasses __setattr__: drop the
                # raw-scale device recipe first
                (self.__dict__.get("_dev_recipes") or {}).pop("U_sz", None)
                sub = self.U_sz[:, ~self.small_U_pop]
                sums = sub.sum(0)
                self.U_sz[:, ~self.small_U_pop] = sub * (
                    np.median(sums) / sums)
            else:
                sums = self.U_sz.sum(0)
                self.U_sz, _ = _scaled_pair(self.U_sz,
                                            np.median(sums) / sums, 0, False)
        elif which == "imputed":
            sums = self.Sx.sum(0)
            self.Sx_sz, _ = _scaled_pair(self.Sx, np.median(sums) / sums,
                                         0, False)
            if skip_low_U_pop:
                self.Ux_sz = np.copy(self.Ux)
                sub = self.Ux[:, ~self.small_U_pop]
                sums = sub.sum(0)
                self.Ux_sz[:, ~self.small_U_pop] = sub * (
                    np.median(sums) / sums)
            else:
                sums = self.Ux.sum(0)
                self.Ux_sz, _ = _scaled_pair(self.Ux, np.median(sums) / sums,
                                             0, False)

    # ------------------------------------------------------------------
    # dimensionality reduction + smoothing (reference :678-702, :933-1118)
    # ------------------------------------------------------------------

    def perform_PCA(self, which: str = "S_norm",
                    n_components: Optional[int] = None,
                    div_by_std: bool = False) -> None:
        """PCA with cells as samples via XLA SVD (reference :678-702)."""
        X = getattr(self, which)
        self.pca = PCA(n_components=n_components)
        if div_by_std:
            self.pcs = self.pca.fit_transform(X.T / X.std(0))
        else:
            self.pcs = self.pca.fit_transform(X.T)

    def _perform_PCA_imputed(self, n_components: Optional[int] = None) -> None:
        self.pcax = PCA(n_components=n_components)
        self.pcsx = self.pcax.fit_transform(self.Sx_norm.T)

    def knn_imputation(self, k: Optional[int] = None, pca_space: bool = True,
                       metric: str = "euclidean", diag: float = 1,
                       n_pca_dims: Optional[int] = None, maximum: bool = False,
                       size_norm: bool = True, balanced: bool = False,
                       b_sight: Optional[int] = None,
                       b_maxl: Optional[int] = None,
                       group_constraint: Union[str, np.ndarray, None] = None,
                       n_jobs: int = 8) -> None:
        """kNN smoothing of S_sz/U_sz -> Sx/Ux (reference :933-1023).

        Fully device-resident (ops.knn_device): blocked-matmul candidate
        search, exact f64 re-score, greedy balancing as a speculative
        batched while_loop (bit-equal to the reference numba loop), and
        the smoothing convolution as blocked scatter-to-dense +
        matmul.  Sx/Ux stay on device between stages; the host-facing
        .knn / .knn_smoothing_w csr views materialize lazily on first
        access.
        """
        N = self.S.shape[1]
        if k is None:
            k = int(N * 0.025)
        if b_sight is None and balanced:
            b_sight = np.minimum(int(k * 8), N - 1)
        if b_maxl is None and balanced:
            b_maxl = np.minimum(int(k * 4), N - 1)
        space = self.pcs[:, :n_pca_dims] if pca_space else self.S_norm.T
        from .ops import knn_device as kd
        mesh = getattr(self, "mesh", None)
        if balanced:
            constraint = None
            if group_constraint is not None:
                if isinstance(group_constraint, str) and \
                        group_constraint == "clusters":
                    constraint = np.array(self.cluster_ix)
                else:
                    constraint = np.asarray(group_constraint)
            g = kd.balanced_knn_graph_dev(space, k=k, sight_k=b_sight,
                                          maxl=b_maxl, metric=metric,
                                          constraint=constraint, mesh=mesh)
        else:
            if group_constraint is not None:
                raise ValueError("group_constraint is currently supported "
                                 "only if the argument balanced is set to True")
            g = kd.knn_graph_dev(space, k=k, metric=metric, mesh=mesh)
        # device-resident graph; .knn / .knn_smoothing_w materialize lazily
        for stale in ("knn", "knn_smoothing_w"):
            self.__dict__.pop(stale, None)
        self._knn_graph_dev = g
        self._knn_diag = diag
        nbr_idx, nbr_w = kd.compact_weights_dev(g, diag=diag)

        S_src = self._get_dev("S_sz" if size_norm else "S")
        U_src = self._get_dev("U_sz" if size_norm else "U")
        # one convolution pass for both matrices: the smoothing is bound
        # by streaming the (B, N) weight slab, which is per-pass, not
        # per-matrix (see ops.knn_device.smooth_dev_multi)
        Sx, Ux = kd.smooth_dev_multi((S_src, U_src), nbr_idx, nbr_w)
        if maximum:
            Sx = jnp.maximum(self._get_dev("S_sz"), Sx)
            Ux = jnp.maximum(self._get_dev("U_sz"), Ux)
        # jax arrays are immutable, so Sx_sz can alias Sx safely
        self._set_dev("Sx", Sx)
        self._set_dev("Ux", Ux)
        self._set_dev("Sx_sz", Sx)
        self._set_dev("Ux_sz", Ux)

    def knn_imputation_precomputed(self, knn_smoothing_w: sparse.spmatrix,
                                   maximum: bool = False) -> None:
        """Smoothing with a precomputed weight matrix (reference :1025-1053)."""
        self.Sx = convolve_by_sparse_weights(self.S_sz, knn_smoothing_w)
        self.Ux = convolve_by_sparse_weights(self.U_sz, knn_smoothing_w)
        if maximum:
            self.Sx = np.maximum(self.S_sz, self.Sx)
            self.Ux = np.maximum(self.U_sz, self.Ux)
        self.Sx_sz = np.copy(self.Sx)
        self.Ux_sz = np.copy(self.Ux)

    def gene_knn_imputation(self, k: int = 15, pca_space: bool = False,
                            metric: str = "correlation", diag: float = 1,
                            scale_weights: bool = True, balanced: bool = True,
                            b_sight: int = 100, b_maxl: int = 18,
                            n_jobs: int = 8) -> None:
        """Gene-axis kNN smoothing (reference :1055-1118)."""
        if pca_space:
            raise NotImplementedError("pca_space=True not supported here")
        space = self.Sx_sz
        if balanced:
            bknn = BalancedKNN(k=k, sight_k=b_sight, maxl=b_maxl,
                               mode="distance", metric=metric, n_jobs=n_jobs)
            bknn.fit(space)
            self.gknn = bknn.kneighbors_graph(mode="distance")
        else:
            self.gknn = knn_distance_matrix(space, metric=metric, k=k,
                                            mode="distance", n_jobs=n_jobs)
        connectivity = (self.gknn > 0).astype(float)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            connectivity.setdiag(diag)
        self.gknn_smoothing_w = connectivity_to_weights(connectivity).tocsr()
        if scale_weights:
            genes_total = np.asarray(space.sum(1)).ravel()
            self.gknn_smoothing_w = scale_to_match_median(
                self.gknn_smoothing_w, genes_total)
        self.Sx_sz = convolve_by_sparse_weights(
            np.ascontiguousarray(self.Sx_sz.T), self.gknn_smoothing_w).T
        self.Ux_sz = convolve_by_sparse_weights(
            np.ascontiguousarray(self.Ux_sz.T), self.gknn_smoothing_w).T

    # ------------------------------------------------------------------
    # gamma model (reference :1120-1439)
    # ------------------------------------------------------------------

    def fit_gammas(self, steady_state_bool: Optional[np.ndarray] = None,
                   use_imputed_data: bool = True, use_size_norm: bool = True,
                   fit_offset: bool = True, fixperc_q: bool = False,
                   weighted: bool = True,
                   weights: Union[str, np.ndarray] = "maxmin_diag",
                   limit_gamma: bool = False,
                   maxmin_perc: List[float] = [2, 98],
                   maxmin_weighted_pow: float = 15) -> None:
        """Fit per-gene degradation rates (reference :1120-1260), with the
        per-gene scipy solves replaced by the vmapped closed forms in
        ops.gamma."""
        if steady_state_bool:
            self.steady_state = steady_state_bool
        else:
            self.steady_state = np.ones(self.S.shape[1], dtype=bool)
        all_ss = bool(np.all(self.steady_state))

        Sname = ("Sx_sz" if use_size_norm else "Sx") if use_imputed_data \
            else ("S_sz" if use_size_norm else "S")
        Uname = ("Ux_sz" if use_size_norm else "Ux") if use_imputed_data \
            else ("U_sz" if use_size_norm else "U")
        if all_ss:
            # device path: matrices stay (or go) on device, the weight
            # schemes run as one fused program (ops.gamma), and only the
            # per-gene results cross the host link
            tmpS = self._get_dev(Sname)
            tmpU = self._get_dev(Uname)
        else:
            tmpS = getattr(self, Sname)
            tmpU = getattr(self, Uname)

        W = None
        if weighted:
            if type(weights) is np.ndarray:
                W = weights
            elif weights not in ("sum", "prod", "maxmin_weighted", "maxmin",
                                 "maxmin_diag", "maxmin_double"):
                raise NotImplementedError(
                    f"weights={weights!r} is not a supported scheme")
            elif all_ss:
                from .ops.gamma import compute_fit_weights
                need_xs = weights in ("maxmin_diag", "maxmin_double")
                W = compute_fit_weights(
                    weights, tmpS, tmpU,
                    self._get_dev("Sx") if need_xs else None,
                    self._get_dev("Ux") if need_xs else None,
                    maxmin_perc, maxmin_weighted_pow)
            else:
                W = self._fit_weights_host(weights, tmpS, tmpU, maxmin_perc,
                                           maxmin_weighted_pow)

        if all_ss:
            ssU, ssS = tmpU, tmpS
        else:
            ssU = tmpU[:, self.steady_state]
            ssS = tmpS[:, self.steady_state]

        if fit_offset:
            if weighted:
                self.gammas, self.q, self.R2 = fit_slope_weighted_offset(
                    ssU, ssS, W, return_R2=True, limit_gamma=limit_gamma)
            else:
                self.gammas, self.q = fit_slope_offset(ssU, ssS)
        elif fixperc_q:
            if weighted:
                self.gammas, self.q = fit_slope_weighted_offset(
                    ssU, ssS, W, fixperc_q=True, return_R2=False,
                    limit_gamma=limit_gamma)
            else:
                self.gammas, self.q = fit_slope_offset(ssU, ssS,
                                                       fixperc_q=True)
        else:
            if weighted:
                self.gammas, self.R2 = fit_slope_weighted(
                    ssU, ssS, W, return_R2=True, limit_gamma=limit_gamma)
                self.q = np.zeros_like(self.gammas)
            else:
                self.gammas = fit_slope(ssU, ssS)
                self.q = np.zeros_like(self.gammas)
        self.gammas[~np.isfinite(self.gammas)] = 0

    def _fit_weights_host(self, weights: str, tmpS, tmpU, maxmin_perc,
                          maxmin_weighted_pow):
        """Host f64 weight schemes (reference analysis.py:1139-1191);
        used only for the non-default steady-state subset path."""
        if weights == "sum":
            return (tmpS / np.percentile(tmpS, 99, 1)[:, None]) + \
                (tmpU / np.percentile(tmpU, 99, 1)[:, None])
        if weights == "prod":
            return (tmpS / np.percentile(tmpS, 99, 1)[:, None]) * \
                (tmpU / np.percentile(tmpU, 99, 1)[:, None])
        if weights == "maxmin_weighted":
            down, up = np.percentile(tmpS, maxmin_perc, 1)
            Srange = np.clip(tmpS, down[:, None], up[:, None])
            Srange = Srange - Srange.min(1)[:, None]
            Srange = Srange / Srange.max(1)[:, None]
            return 0.5 * (Srange ** maxmin_weighted_pow +
                          (1 - Srange) ** maxmin_weighted_pow)
        if weights == "maxmin":
            down, up = np.percentile(tmpS, maxmin_perc, 1)
            return ((tmpS <= down[:, None]) |
                    (tmpS >= up[:, None])).astype(float)
        denom_Sx = np.percentile(self.Sx, 99.9, 1)
        if np.sum(denom_Sx == 0):
            denom_Sx[denom_Sx == 0] = np.maximum(
                np.max(self.Sx[denom_Sx == 0, :], 1), 0.001)
        denom_Ux = np.percentile(self.Ux, 99.9, 1)
        if np.sum(denom_Ux == 0):
            denom_Ux[denom_Ux == 0] = np.maximum(
                np.max(self.Ux[denom_Ux == 0, :], 1), 0.001)
        X = self.Sx / denom_Sx[:, None] + self.Ux / denom_Ux[:, None]
        down, up = np.percentile(X, maxmin_perc, axis=1)
        W = ((X <= down[:, None]) | (X >= up[:, None])).astype(float)
        if weights == "maxmin_double":
            down, up = np.percentile(self.Sx, maxmin_perc, 1)
            W = W + ((self.Sx <= down[:, None]) |
                     (self.Sx >= up[:, None])).astype(float)
        return W

    def filter_genes_good_fit(self, minR: float = 0.1,
                              min_gamma: float = 0.01) -> None:
        """Deprecated alias of filter_genes_by_phase_portrait without the
        correlation criterion (reference :1254-1265)."""
        return self.filter_genes_by_phase_portrait(minR2=minR,
                                                   min_gamma=min_gamma,
                                                   minCorr=None)

    def filter_genes_by_phase_portrait(self, minR2: float = 0.1,
                                       min_gamma: float = 0.01,
                                       minCorr: float = 0.1) -> None:
        """Drop genes with bad phase portraits (reference :1267-1319)."""
        def paired_correlation_rows(A, B):
            A_m = A - A.mean(1)[:, None]
            B_m = B - B.mean(1)[:, None]
            return (A_m * B_m).sum(1) / (np.linalg.norm(A_m, 2, 1) *
                                         np.linalg.norm(B_m, 2, 1))
        tmp_filter = np.ones(self.gammas.shape, dtype=bool)
        if minR2 is not None:
            R2_corrected = np.sqrt(np.abs(self.R2)) * np.sign(self.R2)
            tmp_filter = tmp_filter & (R2_corrected > minR2)
        if min_gamma is not None:
            tmp_filter = tmp_filter & (self.gammas > min_gamma)
        if minCorr is not None:
            Corr = paired_correlation_rows(self.Sx_sz, self.Ux_sz)
            tmp_filter = tmp_filter & (Corr > minCorr)
        self.ra = {k: v[tmp_filter] for k, v in self.ra.items()}
        matrixes2filter = ["U", "U_sz", "U_norm", "Ux", "Ux_sz", "Ux_norm",
                           "S", "S_sz", "S_norm", "Sx", "Sx_sz", "Sx_norm"]
        vectors2filter = ["gammas", "q", "R2"]
        for name_attr in matrixes2filter:
            if hasattr(self, name_attr):
                setattr(self, name_attr, getattr(self, name_attr)[tmp_filter, :])
        for name_attr in vectors2filter:
            if hasattr(self, name_attr):
                setattr(self, name_attr, getattr(self, name_attr)[tmp_filter])

    def predict_U(self, which_gamma: str = "gammas", which_S: str = "Sx_sz",
                  which_offset: str = "q") -> None:
        """Upred = gamma * S (+ q) (reference :1321-1346), on device."""
        self.which_S_for_pred = which_S
        gam = jnp.asarray(getattr(self, which_gamma), jnp.float32)
        q = (jnp.zeros_like(gam) if which_offset is None
             else jnp.asarray(getattr(self, which_offset), jnp.float32))
        self._set_dev("Upred", _axpb_dev(self._get_dev(which_S), gam, q))

    def calculate_velocity(self, kind: str = "residual",
                           eps: Optional[float] = None) -> None:
        """velocity = U - Upred (reference :1348-1379), on device."""
        if kind == "residual":
            if self.which_S_for_pred == "Sx_sz":
                vel = _sub_dev(self._get_dev("Ux_sz"),
                               self._get_dev("Upred"))
            elif self.which_S_for_pred == "Sx":
                vel = _sub_dev(self._get_dev("Ux"), self._get_dev("Upred"))
            else:
                raise NotImplementedError(
                    f"Not implemented with which_S = {self.which_S_for_pred}")
        else:
            raise NotImplementedError(
                f"Velocity calculation kind={kind} is not implemented")
        if eps:
            vel = _eps_clip_dev(vel, self._get_dev("Upred"),
                                jnp.float32(eps))
        self._set_dev("velocity", vel)

    def calculate_shift(self, assumption: str = "constant_velocity",
                        delta_t: float = 1) -> None:
        """delta_S extrapolation (Model I / Model II, reference
        :1381-1408), on device."""
        if assumption == "constant_velocity":
            vel = self._get_dev("velocity")
            self._set_dev("delta_S",
                          vel if delta_t == 1 else
                          _scale_dev(vel, jnp.float32(delta_t)))
        elif assumption == "constant_unspliced":
            self._set_dev("delta_S", _shift_model2_dev(
                self._get_dev("Sx_sz"), self._get_dev("Ux_sz"),
                jnp.asarray(self.gammas, jnp.float32),
                jnp.asarray(self.q, jnp.float32), jnp.float32(delta_t)))
        else:
            raise NotImplementedError(
                f"Assumption {assumption} is not implemented")

    def extrapolate_cell_at_t(self, delta_t: float = 1,
                              clip: bool = True) -> None:
        """Extrapolated expression (reference :1410-1439), on device."""
        if self.which_S_for_pred == "Sx_sz":
            Sname, tname = "Sx_sz", "Sx_sz_t"
        elif self.which_S_for_pred == "Sx":
            Sname, tname = "Sx", "Sx_t"
        else:
            raise NotImplementedError(
                "not implemented for other situations other than Sx or Sx_sz")
        out = _extrapolate_dev(self._get_dev(Sname),
                               self._get_dev("delta_S"),
                               jnp.float32(delta_t), clip)
        self._set_dev(tname, out)
        if clip:
            self.used_delta_t = delta_t

    def perform_TSNE(self, n_dims: int = 2, perplexity: float = 30,
                     initial_pos: Optional[np.ndarray] = None,
                     theta: float = 0.5, n_pca_dim: Optional[int] = None,
                     max_iter: int = 1000) -> None:
        """Barnes-Hut TSNE on the PCA space (reference :1441-1450; delegates
        to sklearn exactly as the reference does)."""
        from sklearn.manifold import TSNE
        if initial_pos is None:
            initial_pos = "random"
        bh_tsne = TSNE(n_components=n_dims, perplexity=perplexity,
                       angle=theta, init=initial_pos, max_iter=max_iter)
        self.ts = bh_tsne.fit_transform(self.pcs[:, :n_pca_dim])

    # ------------------------------------------------------------------
    # velocity -> embedding projection (reference :1452-1816)
    # ------------------------------------------------------------------

    def estimate_transition_prob(self, hidim: str = "Sx_sz",
                                 embed: str = "ts", transform: str = "sqrt",
                                 ndims: Optional[int] = None,
                                 n_sight: Optional[int] = None,
                                 psc: Optional[float] = None,
                                 knn_random: bool = True,
                                 sampled_fraction: float = 0.3,
                                 sampling_probs: Tuple[float, float] = (0.5, 0.1),
                                 max_dist_embed: Optional[float] = None,
                                 n_jobs: int = 4,
                                 threads: Optional[int] = None,
                                 calculate_randomized: bool = True,
                                 random_seed: int = 15071990,
                                 **kwargs: Any) -> None:
        """Correlation-based transition probabilities to the embedding
        neighborhood (reference :1452-1668).  The correlation kernels run
        on the device (ops.coldeltacor); kNN + neighbor sampling reproduce the
        reference's numpy RNG sequence."""
        numba_random_seed(random_seed)
        self.which_hidim = hidim

        if "n_neighbors" in kwargs:
            n_neighbors = kwargs.pop("n_neighbors")
            if len(kwargs) > 0:
                logging.warning(f"keyword arguments were passed but could "
                                f"not be interpreted {kwargs}")
        else:
            n_neighbors = None
        if n_sight is None and n_neighbors is None:
            n_neighbors = int(self.S.shape[1] / 5)
        if (n_sight is not None) and (n_neighbors is not None) and \
                n_neighbors != n_sight:
            raise ValueError("n_sight and n_neighbors are different names "
                             "for the same parameter, they cannot be set "
                             "differently")
        if n_sight is not None and n_neighbors is None:
            n_neighbors = n_sight

        if psc is None:
            if transform in ("log", "logratio"):
                psc = 1.0
            elif transform == "sqrt":
                psc = 1e-10
            else:
                psc = 0.0

        # the sampled non-pcs path never materializes the (G, N) state:
        # the transform, correlation kernels and the randomized control
        # all consume the device-backed attributes directly
        use_dev_transform = knn_random and "pcs" not in hidim

        # validate user parameters BEFORE any worker thread starts: an
        # error raised mid-flight would abandon daemon workers doing
        # device uploads and C++ sampling (round-4 advisor finding)
        if transform not in ("log", "logratio", "linear", "sqrt"):
            raise NotImplementedError(
                f"transform={transform} is not a valid parameter")
        if "pcs" not in hidim and ndims is not None:
            raise ValueError(
                f"ndims was set to {ndims} but hidim != 'pcs'. "
                f"Set ndims = None for hidim='{hidim}'")

        embedding = getattr(self, embed)
        self.embedding = embedding
        # sklearn semantics (reference :1547-1549, :1631-1635): the query
        # point is NOT its own neighbor, so the graph holds n_neighbors+1
        # non-self neighbors per row and an empty diagonal
        N = embedding.shape[0]
        nn_k = min(n_neighbors + 1, N - 1)
        mesh = getattr(self, "mesh", None)

        # start the numpy-parity neighbor sampling NOW on a worker
        # thread: the C++ MT19937 replay (native.choice_noreplace_rows,
        # validated bit-for-bit against np.random.choice) releases the
        # GIL and touches numpy's global RNG only at join, so its host
        # work at the 20k operating point hides behind the device-side
        # kNN/permute/transform dispatches below.  Finished row chunks
        # upload asynchronously while later chunks are still sampling,
        # pipelining the sampling with its own transfer.
        sample_thread = None
        _samp_box: dict = {}
        if knn_random:
            p_samp = np.linspace(sampling_probs[0], sampling_probs[1], nn_k)
            p_samp = p_samp / p_samp.sum()
            n_samp = int(sampled_fraction * nn_k)
            samp_dt = np.uint16 if nn_k <= 65536 else np.int32
            from . import native as _native
            if _native.available():
                import threading

                import queue as _queue
                chunk_q: Any = _queue.Queue()
                _samp_box["queue"] = chunk_q

                def _samp_work():
                    try:
                        chunks = []

                        def on_chunk(lo, hi, rows):
                            dev = jax.device_put(rows.astype(samp_dt))
                            chunks.append(dev)
                            # feed the chunk-pipelined kernel consumer:
                            # the correlation kernels for rows [lo, hi)
                            # depend only on this chunk, so their device
                            # work overlaps the sampling of later chunks
                            chunk_q.put((lo, hi, dev))

                        _samp_box["r"] = \
                            _native.choice_noreplace_rows_chunked(
                                random_seed, N, nn_k, n_samp, p_samp,
                                n_chunks=4, on_chunk=on_chunk)
                        _samp_box["chunks"] = chunks
                        chunk_q.put(None)            # done sentinel
                    except BaseException as exc:   # re-raised at join
                        _samp_box["exc"] = exc
                        chunk_q.put(None)

                sample_thread = threading.Thread(target=_samp_work,
                                                 daemon=True)
                sample_thread.start()

        if "pcs" in hidim:  # sic (reference :1531)
            hi_dim = np.array(getattr(self, hidim).T[:, :ndims], order="C")
            hi_dim_t = np.array(getattr(self, hidim + "_t").T[:, :ndims],
                                order="C")
        else:
            hi_dim = None if use_dev_transform else getattr(self, hidim)
            hi_dim_t = hi_dim_t_rndm = None
            if not use_dev_transform:
                # host f64 path; the sampled path computes the
                # displacement transform on device from delta_S directly
                hi_dim_t = hi_dim + self.used_delta_t * self.delta_S
            if calculate_randomized:
                if use_dev_transform:
                    dS = self._get_dev("delta_S")
                    # The plan's draws come from numpy's global stream AT
                    # THIS POINT (reference order: permute between
                    # numba_random_seed and np.random.seed).  The
                    # knn_random path re-seeds the global stream right
                    # below, discarding the post-plan state -- so the
                    # plan can replay from a STATE SNAPSHOT on the worker
                    # (np.random delegates to a global RandomState; a
                    # local RandomState at the same state draws the
                    # identical sequence).  This moves ~2-4 s of
                    # Fisher-Yates at the 50k point off the main thread,
                    # which proceeds straight to the chunk-pipelined
                    # kernel consumption.
                    _plan_state = np.random.get_state()
                    import threading
                    _rndm_box: dict = {}

                    def _rndm_work():
                        try:
                            rs = np.random.RandomState()
                            rs.set_state(_plan_state)
                            perms, sign_bits = _permute_rows_nsign_plan(
                                *dS.shape, rng=rs)
                            self._set_dev(
                                "delta_S_rndm", _permute_apply_dev(
                                    dS, jnp.asarray(_invert_rows(perms)),
                                    jnp.asarray(sign_bits)))
                        except BaseException as exc:  # re-raised at join
                            _rndm_box["exc"] = exc

                    rndm_thread = threading.Thread(target=_rndm_work,
                                                   daemon=True)
                    rndm_thread.start()
                else:
                    self.delta_S_rndm = np.copy(self.delta_S)
                    permute_rows_nsign(self.delta_S_rndm)
                    if hi_dim_t is not None:
                        hi_dim_t_rndm = hi_dim + self.used_delta_t * \
                            self.delta_S_rndm

        if knn_random:
            # sampled mode: the (N, nn) neighbor matrix never leaves the
            # device (sklearn-exact ordering via the f64 re-score); only
            # the host-RNG sampled column positions are uploaded.  On a
            # CPU backend "device" memory is host memory, so the kd-tree
            # beats the O(N^2) brute pass for 2-3D embeddings and costs
            # no transfer.
            if embedding.shape[1] <= 3 and jax.default_backend() == "cpu":
                from sklearn.neighbors import NearestNeighbors
                nn_model = NearestNeighbors(n_neighbors=min(nn_k + 1, N),
                                            n_jobs=n_jobs)
                nn_model.fit(embedding)
                _dists, idx_host = nn_model.kneighbors(embedding)
                idx_dev = jnp.asarray(idx_host.astype(np.int32))
            else:
                from .ops import knn_device as kd
                _dd, idx_dev = kd.knn_search_dev(embedding,
                                                 min(nn_k + 1, N),
                                                 mesh=mesh)
        else:
            if embedding.shape[1] <= 3:
                # low-dim embeddings (tsne/umap, D=2-3): a host kd-tree
                # beats brute-force distances at any scale and matches
                # the reference's sklearn call (analysis.py:1547-1549)
                from sklearn.neighbors import NearestNeighbors
                nn_model = NearestNeighbors(n_neighbors=min(nn_k + 1, N),
                                            n_jobs=n_jobs)
                nn_model.fit(embedding)
                _dists, idx = nn_model.kneighbors(embedding)
            elif mesh is not None:
                from .ops.knn import knn_search_sharded
                _dists, idx = knn_search_sharded(mesh, embedding,
                                                 min(nn_k + 1, N))
            else:
                _dists, idx = knn_search(embedding, min(nn_k + 1, N))
            rows = np.arange(N)
            is_self = idx == rows[:, None]
            first_self = np.where(is_self.any(1), is_self.argmax(1),
                                  idx.shape[1] - 1)
            keep = np.ones_like(idx, dtype=bool)
            keep[rows, first_self] = False
            neigh_full = idx[keep].reshape(N, idx.shape[1] - 1)[:, :nn_k]
            self.embedding_knn = sparse.csr_matrix(
                (np.ones(N * nn_k), neigh_full.ravel(),
                 np.arange(0, N * nn_k + 1, nn_k)),
                shape=(N, N))

        # device-side transform for the sampled path: the elementwise
        # (G, N) displacement transform runs in f32 on the accelerator
        # (the correlation kernels consume f32 anyway); at 20k x 2k this
        # replaces ~15 s of host f64 full-matrix passes.  The host f64
        # _transform_for_corr stays for the full variant and the "pcs"
        # hidim (where hi_dim_t is an independent attribute).
        if knn_random:
            np.random.seed(random_seed)
            self.corr_calc = "knn_random"
            # Pick random neighbours and prune the rest (reference
            # :1551-1572): the reference's per-cell np.random.choice
            # loop (analysis.py:1555-1560) ran on the worker thread
            # started above (exact MT19937 replay, validated
            # bit-for-bit); numpy's global stream is positioned to the
            # matching state at join.  The drawn COLUMN POSITIONS are
            # data-independent, so the self-drop and the gather of the
            # sampled neighbors fuse into one device program.
            # transforms are computed BEFORE the sampling join so the
            # chunk-pipelined kernels below can dispatch per sampled row
            # chunk as it arrives (the device work for rows [lo, hi)
            # overlaps the host sampling of later chunks)
            if use_dev_transform:
                kernel_tf = {"log": "log10", "logratio": "linear",
                             "linear": "linear", "sqrt": "sqrt"}[transform]
                hi32 = self._get_dev(hidim)
                emat = (_log2_psc_dev(hi32, psc)
                        if transform == "logratio" else hi32)
                d_main = _corr_transform_dev(
                    hi32, self._get_dev("delta_S"),
                    self.used_delta_t, psc, transform)
                d_rndm = None
                if calculate_randomized:
                    rndm_thread.join()   # upload+apply worker from above
                    if "exc" in _rndm_box:
                        raise _rndm_box["exc"]
                    d_rndm = _corr_transform_dev(
                        hi32, self._get_dev("delta_S_rndm"),
                        self.used_delta_t, psc, transform)
                tf = kernel_tf
            else:
                tf, emat, d_main, d_rndm = self._transform_for_corr(
                    transform, psc, hi_dim, hi_dim_t,
                    hi_dim_t_rndm if calculate_randomized else None)
            # compact-first AND device-first: the kernels return the
            # (N, nn) sampled form as device arrays that never cross the
            # host link here.  calculate_embedding_shift consumes them on
            # device; the dense (N, N) corrcoef / transition_prob the
            # reference API exposes are materialized lazily by
            # __getattr__ on first access.
            from .ops.coldeltacor import (col_delta_cor_partial_compact_dev,
                                          col_delta_cor_partial_sharded_dev,
                                          make_partial_compact_chunked)

            neigh_parts: list = []
            cm_parts: list = []
            cr_parts: list = []
            chunk_q = _samp_box.get("queue")
            if mesh is None and chunk_q is not None:
                # chunk-pipelined consumption: dispatch the neighbor
                # gather + correlation kernels for each sampled row
                # chunk as the sampler produces it
                prep_d, run_chunk = make_partial_compact_chunked(
                    emat, tf, psc)
                d_main_rows = prep_d(d_main)
                d_rndm_rows = (prep_d(d_rndm)
                               if calculate_randomized else None)
                try:
                    while True:
                        item = chunk_q.get()
                        if item is None:
                            break
                        lo, hi, samp_chunk = item
                        neigh = _sample_neighbors_dev(idx_dev[lo:hi],
                                                      samp_chunk,
                                                      row_offset=lo)
                        neigh_parts.append(neigh)
                        cm_parts.append(run_chunk(d_main_rows, lo, hi,
                                                  neigh))
                        if calculate_randomized:
                            cr_parts.append(run_chunk(d_rndm_rows, lo, hi,
                                                      neigh))
                except BaseException:
                    if sample_thread is not None:
                        sample_thread.join()
                    raise

            _nat = None
            if sample_thread is not None:
                sample_thread.join()
                if "exc" in _samp_box:
                    raise _samp_box["exc"]
                _nat = _samp_box.get("r")
            if _nat is not None:
                sampling_ixs, _draws, _mt_state = _nat
                if _mt_state is not None:
                    np.random.set_state(_mt_state)
                else:
                    np.random.random_sample(_draws)
            else:
                sampling_ixs = np.stack(
                    [np.random.choice(nn_k, size=(n_samp,),
                                      replace=False, p=p_samp)
                     for _ in range(N)], 0)
            self.sampling_ixs = sampling_ixs
            if neigh_parts:
                neigh_ixs = (neigh_parts[0] if len(neigh_parts) == 1 else
                             jnp.concatenate(neigh_parts, axis=0))
            else:
                chunks = _samp_box.get("chunks")
                if chunks:
                    samp_dev = chunks[0] if len(chunks) == 1 else \
                        jnp.concatenate(chunks, axis=0)
                else:
                    samp_dev = jnp.asarray(sampling_ixs.astype(samp_dt))
                neigh_ixs = _sample_neighbors_dev(idx_dev, samp_dev)
            # embedding_knn materializes lazily from the device indices
            for stale in ("embedding_knn", "_compact_ixs"):
                self.__dict__.pop(stale, None)
            self._compact_ixs_dev = neigh_ixs

            def _compact_dev(d):
                if mesh is not None:
                    return col_delta_cor_partial_sharded_dev(
                        mesh, emat, d, neigh_ixs, tf, psc)
                return col_delta_cor_partial_compact_dev(emat, d, neigh_ixs,
                                                         tf, psc)

            def _fix_nans(dev):
                # reference nan handling (analysis.py:1604-1614): the
                # diagonal is never sampled (neighbors exclude self), so
                # the lazy scatter's implicit zero is fill_diagonal(0).
                # Only the one flag byte crosses the host link.
                had_nan = bool(jnp.any(jnp.isnan(dev)))
                if had_nan:
                    dev = jnp.where(jnp.isnan(dev), jnp.float32(1.0), dev)
                return dev, had_nan

            cm_main = (jnp.concatenate(cm_parts, axis=0) if cm_parts
                       else _compact_dev(d_main))
            cm_dev, had_nan = _fix_nans(cm_main)
            if had_nan:
                logging.warning(
                    "Nans encountered in corrcoef and corrected to 1s. "
                    "If not identical cells were present it is probably "
                    "a small isolated cluster converging after imputation.")
            self._corr_dev = cm_dev
            # the reference overwrites corrcoef here but leaves any old
            # transition_prob stale until the next embedding-shift call:
            # drop the dense caches that estimate_* overwrites, keep the
            # stale-but-materialized transition_prob for parity
            for stale in ("_compact_corr", "corrcoef", "_tp_sigma"):
                self.__dict__.pop(stale, None)
            if calculate_randomized:
                cr_main = (jnp.concatenate(cr_parts, axis=0) if cr_parts
                           else _compact_dev(d_rndm))
                cr_dev, _ = _fix_nans(cr_main)
                self._corr_rndm_dev = cr_dev
                for stale in ("_compact_corr_random", "corrcoef_random"):
                    self.__dict__.pop(stale, None)
        else:
            self.corr_calc = "full"
            for stale in ("_corr_dev", "_corr_rndm_dev", "_compact_corr",
                          "_compact_corr_random", "_compact_ixs",
                          "_compact_ixs_dev", "_tp_sigma"):
                self.__dict__.pop(stale, None)
            tf, emat, d_main, d_rndm = self._transform_for_corr(
                transform, psc, hi_dim, hi_dim_t,
                hi_dim_t_rndm if calculate_randomized else None)
            self.corrcoef = col_delta_cor(emat, d_main, tf, psc, mesh=mesh)
            if calculate_randomized:
                self.corrcoef_random = col_delta_cor(emat, d_rndm, tf, psc,
                                                     mesh=mesh)
            np.fill_diagonal(self.corrcoef, 0)
            if calculate_randomized:
                np.fill_diagonal(self.corrcoef_random, 0)

    def _transform_for_corr(self, transform: str, psc: float,
                            hi_dim: np.ndarray, hi_dim_t: np.ndarray,
                            hi_dim_t_rndm: Optional[np.ndarray]):
        """Prepare (kernel transform name, emat, dmat, dmat_random) for the
        colDeltaCor call, replicating reference :1575-1601."""
        if transform == "log":
            delta = hi_dim_t - hi_dim
            d_main = np.log10(np.abs(delta) + psc) * np.sign(delta)
            d_rndm = None
            if hi_dim_t_rndm is not None:
                dr = hi_dim_t_rndm - hi_dim
                d_rndm = np.log10(np.abs(dr) + psc) * np.sign(dr)
            return "log10", hi_dim, d_main, d_rndm
        if transform == "logratio":
            log2hidim = np.log2(hi_dim + psc)
            d_main = np.log2(np.abs(hi_dim_t) + psc) - log2hidim
            d_rndm = None
            if hi_dim_t_rndm is not None:
                d_rndm = np.log2(np.abs(hi_dim_t_rndm) + psc) - log2hidim
            return "linear", log2hidim, d_main, d_rndm
        if transform == "linear":
            d_rndm = None if hi_dim_t_rndm is None else hi_dim_t_rndm - hi_dim
            return "linear", hi_dim, hi_dim_t - hi_dim, d_rndm
        if transform == "sqrt":
            delta = hi_dim_t - hi_dim
            d_main = np.sqrt(np.abs(delta) + psc) * np.sign(delta)
            d_rndm = None
            if hi_dim_t_rndm is not None:
                dr = hi_dim_t_rndm - hi_dim
                d_rndm = np.sqrt(np.abs(dr) + psc) * np.sign(dr)
            return "sqrt", hi_dim, d_main, d_rndm
        raise NotImplementedError(
            f"transform={transform} is not a valid parameter")

    # ------------------------------------------------------------------
    # lazy dense views of the compact correlation state
    # ------------------------------------------------------------------
    #
    # estimate_transition_prob(knn_random=True) keeps only the compact
    # (N, nn) sampled correlations, as device arrays.  The dense (N, N)
    # corrcoef / transition_prob the reference API exposes
    # (analysis.py:1604-1683) are O(N^2) f64 host arrays whose only role
    # is API parity — they are scattered on first attribute access so
    # pipelines that never touch them never pay the device->host pull
    # nor the dense materialization.

    _LAZY_DENSE = ("corrcoef", "corrcoef_random",
                   "transition_prob", "transition_prob_random")

    def __getattr__(self, name: str):
        # only reached when normal lookup fails: materialize lazy views
        d = self.__dict__
        if name in (d.get("_dev_state") or ()):
            return self._materialize_dev(name)
        if name in VelocytoLoom._LAZY_DENSE:
            return self._materialize_dense(name)
        if name in ("knn", "knn_smoothing_w") and \
                d.get("_knn_graph_dev") is not None:
            return self._materialize_knn(name)
        if name == "_compact_ixs" and d.get("_compact_ixs_dev") is not None:
            ixs = np.array(d["_compact_ixs_dev"], dtype=np.int64)
            d["_compact_ixs"] = ixs
            return ixs
        if name == "embedding_knn" and \
                d.get("_compact_ixs_dev") is not None:
            ixs = self._compact_ixs
            n, nn = ixs.shape
            eknn = sparse.csr_matrix(
                (np.ones(n * nn), ixs.ravel(),
                 np.arange(0, n * nn + 1, nn)), shape=(n, n))
            d["embedding_knn"] = eknn
            return eknn
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def _materialize_knn(self, name: str):
        """Lazy host csr views of the device-resident kNN graph
        (reference exposes .knn and .knn_smoothing_w as scipy csr)."""
        from .ops import knn_device as kd
        g = self.__dict__["_knn_graph_dev"]
        if name == "knn":
            out = kd.graph_to_csr(g)
        else:
            out = kd.weights_to_csr(g, diag=self.__dict__.get("_knn_diag", 1))
        self.__dict__[name] = out
        return out

    def _compact_corr_host(self, which: str = "main") -> np.ndarray:
        """Host f64 copy of the compact correlations, pulled from the
        device handle on first use and cached."""
        key = "_compact_corr" if which == "main" else "_compact_corr_random"
        cached = self.__dict__.get(key)
        if cached is None:
            dev = self.__dict__.get(
                "_corr_dev" if which == "main" else "_corr_rndm_dev")
            if dev is None:
                raise AttributeError(key)
            cached = np.asarray(dev, dtype=np.float64)
            self.__dict__[key] = cached
        return cached

    def _compact_ixs_or_none(self) -> Optional[np.ndarray]:
        ixs = self.__dict__.get("_compact_ixs")
        if ixs is None and self.__dict__.get("_compact_ixs_dev") is not None:
            ixs = self._compact_ixs          # lazy pull + cache
        return ixs

    def _materialize_dense(self, name: str) -> np.ndarray:
        ixs = self._compact_ixs_or_none()
        if ixs is None:
            raise AttributeError(name)
        which = "main" if not name.endswith("_random") else "rndm"
        cm = self._compact_corr_host(which)      # may raise AttributeError
        if name.startswith("transition_prob"):
            sig = self.__dict__.get("_tp_sigma")
            if sig is None:                      # no embedding-shift call yet
                raise AttributeError(name)
            cm = np.exp(cm / sig)
            cm = cm / cm.sum(1)[:, None]
        n = ixs.shape[0]
        dense = np.zeros((n, n), dtype=np.float64)
        dense[np.arange(n)[:, None], ixs] = cm
        self.__dict__[name] = dense
        return dense

    def _has_rndm_state(self) -> bool:
        """hasattr(self, 'corrcoef_random') without forcing the dense
        materialization of the lazy view."""
        d = self.__dict__
        return ("corrcoef_random" in d or "_compact_corr_random" in d
                or d.get("_corr_rndm_dev") is not None)

    def _compact_state_valid(self) -> bool:
        """Whether the compact (N, nn) correlation state stored by
        estimate_transition_prob still corresponds to self.corrcoef.
        If the dense view was materialized (and possibly mutated by the
        caller) it is spot-checked on a random sample of entries."""
        ixs_any = self.__dict__.get("_compact_ixs")
        if ixs_any is None:
            ixs_any = self.__dict__.get("_compact_ixs_dev")
        if ixs_any is None or getattr(self, "corr_calc", None) != "knn_random":
            return False
        if (self.__dict__.get("_corr_dev") is None
                and self.__dict__.get("_compact_corr") is None):
            return False
        n = ixs_any.shape[0]
        dense = self.__dict__.get("corrcoef")
        if dense is None:
            return True                      # never materialized => pristine
        if dense.shape[0] != n:
            return False
        ixs = self._compact_ixs_or_none()
        cm = self._compact_corr_host("main")
        if ixs.shape != cm.shape:
            return False
        rng = np.random.RandomState(0)
        r = rng.randint(0, n, size=min(256, n))
        c = rng.randint(0, ixs.shape[1], size=len(r))
        return bool(np.array_equal(dense[r, ixs[r, c]], cm[r, c]))

    def calculate_embedding_shift(self, sigma_corr: float = 0.05,
                                  expression_scaling: bool = True,
                                  scaling_penalty: float = 1.0) -> None:
        """Project velocity onto the embedding (reference :1670-1733).

        knn_random mode runs entirely on the compact (N, nn) sampled
        form (softmax, unit-vector contraction, expression scaling) --
        only the API-parity dense transition_prob is materialized by
        scatter.  Full mode (and externally modified corrcoef) uses the
        blocked dense kernel; both avoid the reference's (2, N, N)
        unitary-vector tensor (analysis.py:1704-1712).
        """
        if self.corr_calc not in ("full", "knn_random"):
            raise NotImplementedError(
                f"Weird value self.corr_calc={self.corr_calc}")
        if self._compact_state_valid():
            return self._calculate_embedding_shift_compact(
                sigma_corr, expression_scaling, scaling_penalty)
        knn_dense = self.embedding_knn.toarray().astype(np.float32)
        self.transition_prob = np.exp(self.corrcoef / sigma_corr) * knn_dense
        self.transition_prob /= self.transition_prob.sum(1)[:, None]
        if self._has_rndm_state():
            self.transition_prob_random = np.exp(
                self.corrcoef_random / sigma_corr) * knn_dense
            self.transition_prob_random /= \
                self.transition_prob_random.sum(1)[:, None]

        emb = self.embedding.astype(np.float32)
        knn_rowsum = knn_dense.sum(1)
        mesh = getattr(self, "mesh", None)

        def _shift(P):
            if mesh is not None:
                return _embedding_shift_sharded(
                    mesh, emb, P.astype(np.float32), knn_dense, knn_rowsum)
            return _embedding_shift_blocked(
                jnp.asarray(emb), jnp.asarray(P, dtype=jnp.float32),
                jnp.asarray(knn_dense), jnp.asarray(knn_rowsum))

        de = _shift(self.transition_prob)
        self.delta_embedding = np.asarray(de, dtype=np.float64)

        if expression_scaling:
            hi_dim = getattr(self, self.which_hidim)
            estim_delta = hi_dim.dot(self.transition_prob.T) - \
                hi_dim.dot((knn_dense / knn_rowsum[:, None]).T)
            cos_proj = (self.delta_S * estim_delta).sum(0) / \
                np.sqrt((estim_delta ** 2).sum(0))
            self.scaling = np.clip(cos_proj / scaling_penalty, 0, 1)
            self.delta_embedding = self.delta_embedding * self.scaling[:, None]

        if self._has_rndm_state():
            de_r = _shift(self.transition_prob_random)
            self.delta_embedding_random = np.asarray(de_r, dtype=np.float64)
            if expression_scaling:
                estim_delta_rndm = hi_dim.dot(self.transition_prob_random.T) - \
                    hi_dim.dot((knn_dense / knn_rowsum[:, None]).T)
                cos_proj_rndm = (self.delta_S_rndm * estim_delta_rndm).sum(0) / \
                    np.sqrt((estim_delta_rndm ** 2).sum(0))
                self.scaling_rndm = np.clip(cos_proj_rndm / scaling_penalty,
                                            0, 1)
                self.delta_embedding_random = \
                    self.delta_embedding_random * self.scaling_rndm[:, None]

    def _calculate_embedding_shift_compact(self, sigma_corr: float,
                                           expression_scaling: bool,
                                           scaling_penalty: float) -> None:
        """knn_random-mode embedding shift on the compact (N, nn) form.

        Same math as the dense path (the knn mask IS the sampled
        candidate set), but the softmax, unit-vector contraction, and
        expression-scaling projection all run in O(N * nn) -- the only
        O(N^2) work left is the scatter that materializes the dense
        transition_prob for API parity.
        """
        ixs = self.__dict__.get("_compact_ixs_dev")
        if ixs is None:
            ixs = self._compact_ixs
        mesh = getattr(self, "mesh", None)

        def _p_dev(which):
            # softmax over the sampled candidate set, on device (f32);
            # the O(N^2) dense transition_prob stays a lazy __getattr__
            # view so nothing dense crosses the host link here
            dev = self.__dict__.get(
                "_corr_dev" if which == "main" else "_corr_rndm_dev")
            if dev is None:
                dev = jnp.asarray(self._compact_corr_host(which),
                                  jnp.float32)
            return _compact_softmax(dev, float(sigma_corr))

        self.__dict__.pop("transition_prob", None)
        self._tp_sigma = float(sigma_corr)
        p_main = _p_dev("main")
        have_rndm = self._has_rndm_state()
        if have_rndm:
            self.__dict__.pop("transition_prob_random", None)
            p_rndm = _p_dev("rndm")

        emb = self.embedding.astype(np.float32)
        self.delta_embedding = _embedding_shift_compact(
            mesh, emb, ixs, p_main).astype(np.float64)

        if expression_scaling:
            # device transposes of the (G, N) device-backed state; no
            # host materialization for the projection
            hi_rows = self._get_dev(self.which_hidim).T
            d_rows = self._get_dev("delta_S").T
            num, den = _expr_scaling_compact(mesh, hi_rows, d_rows, ixs,
                                             p_main)
            self.scaling = np.clip(num / den / scaling_penalty, 0, 1)
            self.delta_embedding = \
                self.delta_embedding * self.scaling[:, None]

        if have_rndm:
            self.delta_embedding_random = _embedding_shift_compact(
                mesh, emb, ixs, p_rndm).astype(np.float64)
            if expression_scaling:
                dr_rows = self._get_dev("delta_S_rndm").T
                num_r, den_r = _expr_scaling_compact(mesh, hi_rows, dr_rows,
                                                     ixs, p_rndm)
                self.scaling_rndm = np.clip(num_r / den_r / scaling_penalty,
                                            0, 1)
                self.delta_embedding_random = \
                    self.delta_embedding_random * self.scaling_rndm[:, None]

    def calculate_grid_arrows(self, embed: str = "embedding",
                              smooth: float = 0.5,
                              steps: Tuple = (40, 40),
                              n_neighbors: int = 100,
                              n_jobs: int = 4) -> None:
        """Gaussian-kernel grid vector field (reference :1735-1816).

        A regular grid is laid over the embedding (each axis padded by
        2.5% of its span -- the second pad intentionally uses the
        already-padded lower bound, like the reference); each grid
        point kernel-averages the velocity shift of its n_neighbors
        nearest cells with a gaussian of width smooth * grid spacing.
        """
        emb = getattr(self, embed)
        try:
            shift = getattr(self, f"delta_{embed}")
        except AttributeError:
            raise KeyError("This embedding does not have a delta_*")

        def padded_axis(vals, n):
            lo, hi = float(vals.min()), float(vals.max())
            lo -= 0.025 * abs(hi - lo)
            hi += 0.025 * abs(hi - lo)
            return np.linspace(lo, hi, n)

        axes = [padded_axis(emb[:, d], steps[d])
                for d in range(emb.shape[1])]
        grid = np.stack([a.ravel() for a in np.meshgrid(*axes)], axis=1)

        dists, neigh = knn_query(emb, grid, min(n_neighbors, emb.shape[0]))
        kernel_sd = smooth * np.mean([a[1] - a[0] for a in axes])
        w = normal.pdf(x=dists, loc=0, scale=kernel_sd)
        self.total_p_mass = w.sum(1)
        denom = np.maximum(1, self.total_p_mass)[:, None]

        def kernel_average(field):
            return np.einsum("gk,gkd->gd", w, field[neigh]) / denom

        flow = kernel_average(shift)
        self.flow_embedding = emb
        self.flow_grid = grid
        self.flow = flow
        # scale shared with the randomized control: both normalize by
        # the 99.5th-percentile magnitude of the MAIN field (reference
        # :1800-1807 computes magnitude_rndm from UZ, not UZ_rndm)
        scale = np.percentile(np.linalg.norm(flow, axis=1), 99.5)
        self.flow_norm = flow / scale
        self.flow_norm_magnitude = np.linalg.norm(self.flow_norm, axis=1)

        if self._has_rndm_state():
            flow_rndm = kernel_average(
                getattr(self, f"delta_{embed}_random"))
            self.flow_rndm = flow_rndm
            self.flow_norm_rndm = flow_rndm / scale
            self.flow_norm_magnitude_rndm = np.linalg.norm(
                self.flow_norm_rndm, axis=1)

    # ------------------------------------------------------------------
    # markov diffusion (reference :1818-1887)
    # ------------------------------------------------------------------

    def prepare_markov(self, sigma_D: float, sigma_W: float,
                       direction: str = "forward",
                       cells_ixs: Optional[np.ndarray] = None) -> None:
        """Build the Markov transition matrix (reference :1818-1863)."""
        if cells_ixs is None:
            cells_ixs = np.arange(self.transition_prob.shape[0])
        if direction not in ("forward", "backwards"):
            raise NotImplementedError(
                f"{direction} is not an implemented direction")

        def row_stochastic(m):
            return m / m.sum(1)[:, None]

        p = self.transition_prob[np.ix_(cells_ixs, cells_ixs)]
        if direction == "backwards":
            p = np.ascontiguousarray(p.T)
        pair_d = squareform(pdist(self.embedding[cells_ixs, :]))
        # locality-limited velocities, self-transition pinned to the row
        # max, then blended 80/20 with a pure diffusion-noise kernel
        local = p * gaussian_kernel(pair_d, sigma=sigma_D)
        np.fill_diagonal(local, local.max(1))
        noise = row_stochastic(gaussian_kernel(pair_d, sigma=sigma_W))
        blend = 0.8 * row_stochastic(local) + 0.2 * noise
        self.tr = sparse.csr_matrix(row_stochastic(blend))

    def run_markov(self, starting_p: Optional[np.ndarray] = None,
                   n_steps: int = 2500,
                   mode: str = "time_evolution") -> None:
        """Run the diffusion process (reference :1865-1887)."""
        if starting_p is None:
            starting_p = np.ones(self.tr.shape[0]) / self.tr.shape[0]
        diffusor = Diffusion()
        self.diffused = diffusor.diffuse(starting_p, self.tr,
                                         n_steps=n_steps, mode=mode)[0]

    # ------------------------------------------------------------------
    # deprecated one-shot defaults (reference :1889-1964)
    # ------------------------------------------------------------------

    def default_filter_and_norm(self, min_expr_counts: Optional[int] = None,
                                min_cells_express: Optional[int] = None,
                                N: Optional[int] = None,
                                min_avg_U: Optional[float] = None,
                                min_avg_S: Optional[float] = None) -> None:
        """Heuristic filtering + normalization (reference :1889-1940)."""
        if min_expr_counts is None:
            min_expr_counts = max(20, min(100, self.S.shape[1] * 2.25e-3))
        if min_cells_express is None:
            min_cells_express = max(10, min(50, self.S.shape[1] * 1.5e-3))
        if N is None:
            N = max(1000, min(int((self.S.shape[1] / 1000) ** (1 / 3) / 0.0008),
                              5000))
        if min_avg_U is None:
            min_avg_U = 0.01
        if min_avg_S is None:
            min_avg_S = 0.08
        self.normalize("S", size=True, log=False)
        self.normalize("U", size=True, log=False)
        self.score_detection_levels(min_expr_counts=min_expr_counts,
                                    min_cells_express=min_cells_express)
        self.filter_genes(by_detection_levels=True)
        self.score_cv_vs_mean(N=N, max_expr_avg=40)
        self.filter_genes(by_cv_vs_mean=True)
        self.score_detection_levels(
            min_expr_counts=0, min_cells_express=0,
            min_expr_counts_U=int(min_expr_counts / 2) + 1,
            min_cells_express_U=int(min_cells_express / 2) + 1)
        if hasattr(self, "cluster_labels"):
            self.score_cluster_expression(min_avg_U=min_avg_U,
                                          min_avg_S=min_avg_S)
            self.filter_genes(by_detection_levels=True,
                              by_cluster_expression=True)
        else:
            self.filter_genes(by_detection_levels=True)
        self.normalize_by_total()
        self.adjust_totS_totU(normalize_total=True)

    def default_fit_preparation(self, k: Optional[int] = None,
                                n_comps: Optional[int] = None) -> None:
        """Heuristic PCA + kNN smoothing (reference :1942-1964)."""
        self.perform_PCA()
        if n_comps is None:
            n_comps = int(np.where(np.diff(np.diff(np.cumsum(
                self.pca.explained_variance_ratio_)) > 0.002))[0][0])
        if k is None:
            k = int(min(1000, max(10, np.ceil(self.S.shape[1] * 0.02))))
        self.knn_imputation(n_pca_dims=n_comps, k=k, balanced=True,
                            b_sight=int(min(k * 8, self.S.shape[1] - 1)),
                            b_maxl=int(min(k * 4, self.S.shape[1] - 1)))
        self.normalize_median()

    # ------------------------------------------------------------------
    # plotting (host-side matplotlib; reference :96-135, :1966-2312)
    # ------------------------------------------------------------------

    def plot_fractions(self, save2file: Optional[str] = None) -> None:
        """Per-sample barplot of the spliced/ambiguous/unspliced molecule
        fractions (same figure contract as reference plot_fractions
        :96-135: grouped bars per sample with std error bars)."""
        plt = _plt()
        if "SampleID" in self.ca:
            labels = np.asarray(self.ca["SampleID"])
        else:
            # sample prefix of the "sample:barcode" CellID convention
            labels = np.array([c.split(":")[0] for c in self.ca["CellID"]])
        samples, sample_ix = np.unique(labels, return_inverse=True)
        per_cell = np.stack([m.sum(0) for m in (self.S, self.A, self.U)])
        frac = per_cell / per_cell.sum(0, keepdims=True)     # (3, N)

        plt.figure(figsize=(3.2, 5))
        ax = plt.gca()
        xs = np.arange(3)
        offsets = np.linspace(-0.2, 0.2, len(samples))
        width = 0.5 / (len(samples) * 1.05)
        for i, name in enumerate(samples):
            sel = frac[:, sample_ix == i]
            ax.bar(xs + offsets[i], sel.mean(1), width, label=name)
            ax.errorbar(xs + offsets[i], sel.mean(1), sel.std(1), c="k",
                        fmt="none", lw=1, capsize=2)
        ax.set_ylabel("Fraction")
        ax.set_xticks(xs)
        ax.set_xticklabels(["spliced", "ambiguous", "unspliced"])
        for side in ("right", "top"):
            ax.spines[side].set_visible(False)
        ax.yaxis.set_ticks_position("left")
        ax.xaxis.set_ticks_position("bottom")
        ax.spines["left"].set_bounds(0, 0.8)
        ax.legend()
        plt.tight_layout()
        if save2file:
            plt.savefig(save2file, bbox_inches="tight")

    def plot_pca(self, dim: List[int] = [0, 1, 2], elev: float = 60,
                 azim: float = -140) -> None:
        """3D PCA scatter (reference :906-915)."""
        plt = _plt()
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(self.pcs[:, dim[0]], self.pcs[:, dim[1]],
                   self.pcs[:, dim[2]], c=self.colorandum)
        ax.view_init(elev=elev, azim=azim)

    def _plot_pca_imputed(self, dim: List[int] = [0, 1, 2], elev: float = 60,
                          azim: float = -140) -> None:
        """3D PCA scatter of the smoothed data (reference :922-931)."""
        plt = _plt()
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(self.pcsx[:, dim[0]], self.pcsx[:, dim[1]],
                   self.pcsx[:, dim[2]], c=self.colorandum)
        ax.view_init(elev=elev, azim=azim)

    def _plot_phase_portrait(self, gene: Optional[str], gs_i: Any = None) -> None:
        plt = _plt()
        if gene is None:
            plt.subplot(111)
        else:
            plt.subplot(gs_i)
        ix = np.where(self.ra["Gene"] == gene)[0][0]
        scatter_viz(self.Sx_sz[ix, :], self.Ux_sz[ix, :], c=self.colorandum,
                    s=5, alpha=0.4)
        plt.title(gene)
        xnew = np.linspace(0, self.Sx_sz[ix, :].max())
        plt.plot(xnew, self.gammas[ix] * xnew + self.q[ix], c="k")

    def plot_phase_portraits(self, genes: List[str]) -> None:
        """Phase portrait grid (reference :1979-1991)."""
        plt = _plt()
        n = len(genes)
        sqrtn = int(np.ceil(np.sqrt(n)))
        gs = plt.GridSpec(sqrtn, int(np.ceil(n / sqrtn)))
        for i, gn in enumerate(genes):
            self._plot_phase_portrait(gn, gs[i])

    def plot_grid_arrows(self, quiver_scale: Union[str, float] = "auto",
                         scale_type: str = "relative", min_mass: float = 1,
                         min_magnitude: Optional[float] = None,
                         scatter_kwargs_dict: Optional[Dict] = None,
                         plot_dots: bool = False, plot_random: bool = False,
                         **quiver_kwargs: Any) -> None:
        """Grid vector-field plot (reference :1993-2093).

        Hidden grid points are either dropped or zeroed (plot_dots):
        below-min_mass points always, below-min_magnitude points when a
        magnitude floor is given (then the normalized field is drawn).
        The quiver scale is calibrated against the randomized control's
        90th-percentile arrow length, like the reference.
        """
        plt = _plt()
        arrow_style = dict({"angles": "xy", "scale_units": "xy",
                            "minlength": 1.5}, **quiver_kwargs)
        dot_style = dict({"s": 20, "zorder": -1, "alpha": 0.2, "lw": 0,
                          "c": self.colorandum},
                         **(scatter_kwargs_dict or {}))

        if scale_type == "relative":
            if not hasattr(self, "flow_rndm"):
                raise ValueError(
                    "`scale_type` was set to 'relative' but the randomized "
                    "control was not computed when running "
                    "estimate_transition_prob")
            span = np.linalg.norm(np.ptp(self.flow_grid, 0), 2)
            typical = np.percentile(np.linalg.norm(
                self.flow_rndm[self.total_p_mass >= min_mass, :], 2, 1), 90)
            base = typical / (span * 0.0025)
            quiver_scale = base if quiver_scale == "auto" \
                else quiver_scale * base

        hidden = self.total_p_mass < min_mass

        def field(which):
            if min_magnitude is None:
                vec, hide = getattr(self, which), hidden
            else:
                vec = getattr(self, which.replace("flow", "flow_norm"))
                mag = self.flow_norm_magnitude if which == "flow" \
                    else self.flow_norm_magnitude_rndm
                hide = hidden | (mag < min_magnitude)
            pts, vec = np.copy(self.flow_grid), np.copy(vec)
            if plot_dots:
                vec[hide, :] = 0
            else:
                pts, vec = pts[~hide, :], vec[~hide, :]
            return pts, vec

        def panel(which):
            pts, vec = field(which)
            plt.scatter(self.flow_embedding[:, 0],
                        self.flow_embedding[:, 1], **dot_style)
            plt.quiver(pts[:, 0], pts[:, 1], vec[:, 0], vec[:, 1],
                       scale=quiver_scale, zorder=20000, **arrow_style)
            plt.axis("off")

        if plot_random:
            plt.subplot(122)
            plt.title("Randomized")
            panel("flow_rndm")
            plt.subplot(121)
            plt.title("Data")
        panel("flow")

    def plot_arrows_embedding(self, choice: Union[str, int] = "auto",
                              quiver_scale: Union[str, float] = "auto",
                              scale_type: str = "relative",
                              plot_scatter: bool = False,
                              scatter_kwargs: Dict = {},
                              color_arrow: str = "cluster",
                              new_fig: bool = False,
                              plot_random: bool = True,
                              **quiver_kwargs: Any) -> None:
        """Cell-wise arrow plot (reference :2095-2190): a random subset
        of cells gets an arrow for its embedding shift, optionally next
        to the randomized-control panel; the quiver scale is calibrated
        against the control's 80th-percentile arrow length."""
        plt = _plt()
        if choice == "auto":
            choice = int(self.S.shape[1] / 3)
        have_rndm = hasattr(self, "delta_embedding_random")
        dot_style = dict(dict(c="0.8", alpha=0.4, s=10,
                              edgecolor=(0, 0, 0, 1), lw=0.3),
                         **scatter_kwargs)
        if new_fig:
            plt.figure(figsize=(22, 12) if plot_random and have_rndm
                       else (14, 14))
        subset = np.random.choice(self.embedding.shape[0], size=choice,
                                  replace=False)
        if scale_type == "relative":
            if not have_rndm:
                raise ValueError(
                    "`scale_type` was set to 'relative' but the randomized "
                    "control was not computed when running "
                    "estimate_transition_prob")
            span = np.linalg.norm(np.ptp(self.flow_grid, 0), 2)
            typical = np.percentile(np.linalg.norm(
                self.delta_embedding_random, 2, 1), 80)
            base = typical / (span * 0.005)
            quiver_scale = base if quiver_scale == "auto" \
                else quiver_scale * base
        arrow_style = dict({"angles": "xy", "scale_units": "xy",
                            "minlength": 1.5,
                            "color": (self.colorandum[subset, :]
                                      if color_arrow == "cluster"
                                      else color_arrow)},
                           **quiver_kwargs)

        def panel(shift):
            if plot_scatter:
                plt.scatter(self.embedding[:, 0], self.embedding[:, 1],
                            **dot_style)
            plt.quiver(self.embedding[subset, 0], self.embedding[subset, 1],
                       shift[subset, 0], shift[subset, 1],
                       scale=quiver_scale, **arrow_style)
            plt.axis("off")

        if plot_random and have_rndm:
            plt.subplot(122)
            plt.title("Randomized")
            panel(self.delta_embedding_random)
            plt.subplot(121)
            plt.title("Data")
        panel(self.delta_embedding)

    def plot_cell_transitions(self, cell_ix: int = 0, alpha: float = 0.1,
                              alpha_neigh: float = 0.2,
                              cmap_name: str = "RdBu_r",
                              plot_arrow: bool = True,
                              mark_cell: bool = True,
                              head_width: int = 3) -> None:
        """Transition probabilities from one cell (reference :2192-2212)."""
        plt = _plt()
        colorandum = np.ones((self.embedding.shape[0], 4))
        colorandum *= 0.3
        colorandum[:, -1] = alpha
        plt.scatter(self.embedding[:, 0], self.embedding[:, 1],
                    c=colorandum, s=50, edgecolor="none")
        if mark_cell:
            plt.scatter(self.embedding[cell_ix, 0], self.embedding[cell_ix, 1],
                        facecolor="none", s=100, edgecolor="k")
        if plot_arrow:
            plt.arrow(self.embedding[cell_ix, 0], self.embedding[cell_ix, 1],
                      self.delta_embedding[cell_ix, 0],
                      self.delta_embedding[cell_ix, 1],
                      head_width=head_width, length_includes_head=True)

    def _embedding_gene_scatter(self, unit_values: np.ndarray, cmap: Any,
                                gs: Any, which_tsne: str, title: str,
                                **kwargs: Any) -> None:
        """One styled embedding scatter colored by per-cell values in
        [0, 1] (shared body of the *_as_color plots)."""
        plt = _plt()
        opts = {"alpha": 0.5, "s": 8, "edgecolor": "0.8", "lw": 0.15}
        opts.update(kwargs)
        if gs is None:
            plt.figure(figsize=(10, 10))
            plt.subplot(111)
        else:
            plt.subplot(gs)
        emb = getattr(self, which_tsne)
        scatter_viz(emb[:, 0], emb[:, 1], c=cmap(unit_values), **opts)
        plt.axis("off")
        plt.title(title)

    def plot_velocity_as_color(self, gene_name: Optional[str] = None,
                               cmap: Any = None, gs: Any = None,
                               which_tsne: str = "ts", **kwargs: Any) -> None:
        """One gene's extrapolated shift on the embedding, as a
        diverging color map centered on zero and clipped at the 1/99th
        percentiles (same figure contract as reference :2214-2262,
        including the flat-velocity early-out)."""
        plt = _plt()
        ix = np.where(self.ra["Gene"] == gene_name)[0][0]
        if self.which_S_for_pred == "Sx_sz":
            shift = self.Sx_sz_t[ix, :] - self.Sx_sz[ix, :]
        else:
            shift = self.Sx_t[ix, :] - self.Sx[ix, :]
        if (np.abs(shift) > 5e-5).sum() < 10:
            print("S vs U scatterplot it is flat")
            return
        limit = np.max(np.abs(np.percentile(shift, [1, 99])))
        vals = np.clip((shift + limit) / (2 * limit), 0, 1)
        self._embedding_gene_scatter(vals, cmap or plt.cm.RdBu_r, gs,
                                     which_tsne, f"{gene_name}", **kwargs)

    def plot_expression_as_color(self, gene_name: Optional[str] = None,
                                 imputed: bool = True, cmap: Any = None,
                                 gs: Any = None, which_tsne: str = "ts",
                                 **kwargs: Any) -> None:
        """One gene's (smoothed or raw size-normalized) expression on
        the embedding, as a sequential map normalized to its 99th
        percentile (same figure contract as reference :2264-2312)."""
        plt = _plt()
        ix = np.where(self.ra["Gene"] == gene_name)[0][0]
        if not imputed:
            expr = self.S_sz[ix, :]
        elif self.which_S_for_pred == "Sx_sz":
            expr = self.Sx_sz[ix, :]
        else:
            expr = self.Sx[ix, :]
        vals = np.clip(expr / np.percentile(expr, 99), 0, 1)
        self._embedding_gene_scatter(vals, cmap or plt.cm.Greens, gs,
                                     which_tsne, f"{gene_name}", **kwargs)

    def reload_raw(self, substitute: bool = False) -> None:
        """Reload pristine matrices from the loom (reference :2314-2342):
        into S/U/A when substitute, else as raw_* copies."""
        prefix = "" if substitute else "raw_"
        ds = loomio.connect(self.loom_filepath)
        try:
            loaded = {}
            for name in ("spliced", "unspliced", "ambiguous"):
                loaded[name] = ds.layer[name][:, :]
                setattr(self, prefix + name[0].upper(), loaded[name])
            setattr(self, prefix + "initial_cell_size",
                    loaded["spliced"].sum(0))
            setattr(self, prefix + "initial_Ucell_size",
                    loaded["unspliced"].sum(0))
            setattr(self, prefix + "ca", dict(ds.col_attrs.items()))
            setattr(self, prefix + "ra", dict(ds.row_attrs.items()))
        finally:
            ds.close()


# ---------------------------------------------------------------------------
# jitted embedding-shift kernel
# ---------------------------------------------------------------------------

def _embedding_shift_rows(emb: jax.Array, emb_rows: jax.Array,
                          P_rows: jax.Array, K_rows: jax.Array,
                          Ks_rows: jax.Array, block: int = 128) -> jax.Array:
    """Embedding shift for a subset of rows: emb (N, D) full embedding;
    emb_rows/P_rows/K_rows/Ks_rows hold the M center rows (M may be a
    shard of N).  Returns (M, D)."""
    n, d = emb.shape
    m = emb_rows.shape[0]
    m_pad = ((m + block - 1) // block) * block
    emb_p = jnp.pad(emb_rows, ((0, m_pad - m), (0, 0)))
    P_p = jnp.pad(P_rows, ((0, m_pad - m), (0, 0)))
    K_p = jnp.pad(K_rows, ((0, m_pad - m), (0, 0)))
    Ks_p = jnp.pad(Ks_rows, ((0, m_pad - m),), constant_values=1.0)

    def block_fn(i0):
        xi = jax.lax.dynamic_slice(emb_p, (i0, 0), (block, d))
        Pi = jax.lax.dynamic_slice(P_p, (i0, 0), (block, n))
        Ki = jax.lax.dynamic_slice(K_p, (i0, 0), (block, n))
        Ksi = jax.lax.dynamic_slice(Ks_p, (i0,), (block,))
        diff = emb[None, :, :] - xi[:, None, :]          # (B, N, D)
        nrm = jnp.linalg.norm(diff, axis=-1)
        unit = jnp.where(nrm[..., None] > 0, diff / jnp.where(
            nrm[..., None] == 0, 1.0, nrm[..., None]), 0.0)
        hp = jax.lax.Precision.HIGHEST
        de = jnp.einsum("bn,bnd->bd", Pi, unit, precision=hp)
        de = de - jnp.einsum("bn,bnd->bd", Ki, unit, precision=hp) / \
            Ksi[:, None]
        return de

    out = jax.lax.map(block_fn, jnp.arange(0, m_pad, block))
    return out.reshape(m_pad, d)[:m]


@functools.partial(jax.jit, static_argnames=("block",))
def _embedding_shift_blocked(emb: jax.Array, P: jax.Array, K: jax.Array,
                             K_rowsum: jax.Array, block: int = 128) -> jax.Array:
    """delta_i = sum_j P_ij * unit(x_j - x_i) - sum_j K_ij unit(..) / sum_j K_ij

    emb: (N, D); P/K: (N, N).  Blocked over i to avoid the reference's
    dense (D, N, N) unitary-vector tensor (analysis.py:1704-1712).
    """
    return _embedding_shift_rows(emb, emb, P, K, K_rowsum, block)


# --- device transition-prob support (reference analysis.py:1452-1668) ---

@jax.jit
def _sample_neighbors_dev(idx: jax.Array, samp: jax.Array,
                          row_offset=0) -> jax.Array:
    """Fused self-drop + sampled-column gather: one device program
    instead of two separately-dispatched gathers (the (N, nn) stack
    never materializes on host).  row_offset: global id of idx's first
    row, for row-chunked calls (the self test compares global ids)."""
    n, cols = idx.shape
    rows = jnp.arange(n, dtype=idx.dtype)[:, None] + \
        jnp.asarray(row_offset, dtype=idx.dtype)
    is_self = idx == rows
    first_self = jnp.where(is_self.any(1), jnp.argmax(is_self, 1), cols - 1)
    # column j of the self-dropped matrix is column j + (j >= first_self)
    # of idx; composing with the sampled positions skips the (N, cols-1)
    # intermediate entirely
    s = samp.astype(jnp.int32)
    src = s + (s >= first_self[:, None])
    return jnp.take_along_axis(idx, src, axis=1)


def _permute_rows_nsign_plan(g: int, n: int, rng=np.random):
    """The row permutations + sign flips permute_rows_nsign would apply,
    computed from the same np.random draw sequence but without touching
    the data -- so the (G, N) matrix itself can stay on device and only
    the plan is uploaded: (G, N) uint16/int32 permutations plus
    bit-packed signs ((G, ceil(N/8)) uint8, 8x smaller than int8).  rng: the global np.random module (default)
    or a RandomState positioned at the same state (identical draws;
    np.random delegates to a global RandomState)."""
    perms = np.empty((g, n), np.uint16 if n <= 65536 else np.int32)
    signs = np.empty((g, n), np.int8)
    plmi = np.array([+1, -1])
    base = np.arange(n)
    for i in range(g):
        p = base.copy()
        rng.shuffle(p)                 # same draw count as shuffling a row
        perms[i] = p
        signs[i] = rng.choice(plmi, size=n)
    return perms, np.packbits(signs > 0, axis=1)


@jax.jit
def _permute_apply_dev(delta: jax.Array, inv_perms: jax.Array,
                       sign_bits: jax.Array) -> jax.Array:
    """Apply per-row permutations + sign flips on device.

    Takes the INVERSE permutations and applies them via lax.sort --
    sorting (inv, delta) by inv puts delta[perm[j]] at position j, and
    a row sort replaces a per-element take_along_axis gather with the
    same, bit-identical output (keys are a permutation, so the reorder
    is exact and the floats are untouched)."""
    n = delta.shape[1]
    byte = jnp.repeat(sign_bits, 8, axis=1)[:, :n]
    shift = (7 - (jnp.arange(n) % 8)).astype(jnp.uint8)
    bit = (byte >> shift[None, :]) & 1
    sign = (2.0 * bit - 1.0).astype(delta.dtype)
    _, permuted = jax.lax.sort(
        (jnp.broadcast_to(inv_perms, delta.shape), delta),
        dimension=1, num_keys=1)
    return permuted * sign


def _invert_rows(perms: np.ndarray) -> np.ndarray:
    """Row-wise inverse of a (G, N) permutation table (RNG-free; runs on
    the randomization worker thread)."""
    inv = np.empty_like(perms)
    rows = np.arange(perms.shape[0])[:, None]
    inv[rows, perms] = np.arange(perms.shape[1],
                                 dtype=perms.dtype)[None, :]
    return inv


# --- device velocity chain (reference analysis.py:1321-1439) ---

@jax.jit
def _axpb_dev(S, gam, q):
    return gam[:, None] * S + q[:, None]


@jax.jit
def _sub_dev(a, b):
    return a - b


@jax.jit
def _scale_dev(a, s):
    return s * a


@jax.jit
def _eps_clip_dev(vel, upred, eps):
    msr = jnp.max(upred, axis=1) * eps
    return jnp.where(jnp.abs(vel) < msr[:, None], 0.0, vel)


@jax.jit
def _shift_model2_dev(Sx_sz, Ux_sz, gammas, q, dt):
    Ux_szo = jnp.maximum(Ux_sz - q[:, None], 0.0)
    egt = jnp.exp(-gammas * dt)[:, None]
    return Sx_sz * egt + (1 - egt) * Ux_szo / gammas[:, None] - Sx_sz


@functools.partial(jax.jit, static_argnames=("clip",))
def _extrapolate_dev(S, dS, dt, clip):
    out = S + dt * dS
    return jnp.maximum(out, 0.0) if clip else out


@functools.partial(jax.jit, static_argnames=("kind",))
def _corr_transform_impl(hi32: jax.Array, d32: jax.Array, dt: jax.Array,
                         psc: jax.Array, kind: str) -> jax.Array:
    """Elementwise displacement transform of estimate_transition_prob
    (reference analysis.py:1575-1601) on device, f32.  delta is dt *
    delta_S directly: the host path's (hi + dt*dS) - hi equals it to one
    f64 ulp, below f32 resolution."""
    delta = dt * d32
    if kind == "log":
        return jnp.log10(jnp.abs(delta) + psc) * jnp.sign(delta)
    if kind == "sqrt":
        return jnp.sqrt(jnp.abs(delta) + psc) * jnp.sign(delta)
    if kind == "linear":
        return delta
    # logratio: log2(|hi_dim_t| + psc) - log2(hi_dim + psc)
    return jnp.log2(jnp.abs(hi32 + delta) + psc) - jnp.log2(hi32 + psc)


def _corr_transform_dev(hi32, d32, dt: float, psc: float,
                        kind: str) -> jax.Array:
    return _corr_transform_impl(hi32, d32, jnp.float32(dt),
                                jnp.float32(psc), kind)


@jax.jit
def _log2_psc_impl(hi32: jax.Array, psc: jax.Array) -> jax.Array:
    return jnp.log2(hi32 + psc)


def _log2_psc_dev(hi32, psc: float) -> jax.Array:
    return _log2_psc_impl(hi32, jnp.float32(psc))


@jax.jit
def _compact_softmax_impl(corr: jax.Array, sigma: jax.Array) -> jax.Array:
    p = jnp.exp(corr / sigma)
    return p / jnp.sum(p, axis=1, keepdims=True)


def _compact_softmax(corr, sigma: float) -> jax.Array:
    """Row softmax of the compact (N, nn) correlations at temperature
    sigma, on device (sigma traced so one compile serves all values)."""
    return _compact_softmax_impl(jnp.asarray(corr, jnp.float32),
                                 jnp.float32(sigma))


def _embedding_shift_compact_rows(emb: jax.Array, emb_rows: jax.Array,
                                  ixs_rows: jax.Array, P_rows: jax.Array,
                                  block: int = 512) -> jax.Array:
    """Compact embedding shift: per row i, the knn mask IS the sampled
    candidate set, so delta_i = sum_k P_ik unit(x_{ixs_ik} - x_i) -
    mean_k unit(x_{ixs_ik} - x_i).  O(N*nn*D) instead of O(N^2*D)."""
    n, d = emb.shape
    m, k = ixs_rows.shape
    m_pad = ((m + block - 1) // block) * block
    emb_p = jnp.pad(emb_rows, ((0, m_pad - m), (0, 0)))
    ixs_p = jnp.pad(ixs_rows, ((0, m_pad - m), (0, 0)))
    P_p = jnp.pad(P_rows, ((0, m_pad - m), (0, 0)))

    def block_fn(i0):
        xi = jax.lax.dynamic_slice(emb_p, (i0, 0), (block, d))
        ix_b = jax.lax.dynamic_slice(ixs_p, (i0, 0), (block, k))
        P_b = jax.lax.dynamic_slice(P_p, (i0, 0), (block, k))
        nb = emb[ix_b]                                # (B, K, D)
        diff = nb - xi[:, None, :]
        nrm = jnp.linalg.norm(diff, axis=-1)
        unit = jnp.where(nrm[..., None] > 0, diff / jnp.where(
            nrm[..., None] == 0, 1.0, nrm[..., None]), 0.0)
        de = jnp.einsum("bk,bkd->bd", P_b, unit,
                        precision=jax.lax.Precision.HIGHEST) - \
            jnp.mean(unit, axis=1)
        return de

    out = jax.lax.map(block_fn, jnp.arange(0, m_pad, block))
    return out.reshape(m_pad, d)[:m]


_embedding_shift_compact_jit = jax.jit(_embedding_shift_compact_rows,
                                       static_argnames=("block",))


def _expr_scaling_compact_rows(hi_rows: jax.Array, d_rows: jax.Array,
                               ixs_rows: jax.Array, P_rows: jax.Array,
                               block: int = 16, nt: int = 128):
    """cos-projection numerator/denominator of the expression-scaling
    penalty on the compact form (reference analysis.py:1714-1719):
    estim_delta_i = sum_k P_ik hi[ixs_ik] - mean_k hi[ixs_ik];
    returns (num_i = <delta_S_i, estim_i>, den_i = ||estim_i||).

    The neighbor axis is tiled (nt) so the gathered (block, nt, G)
    intermediate stays tens of MB at reference scale; estim accumulates
    over the tiles (sum_k is tile-separable; the mean's 1/K factor is
    applied at the end)."""
    m, k = ixs_rows.shape
    g = hi_rows.shape[1]
    nt = min(nt, k)
    k_pad = ((k + nt - 1) // nt) * nt
    m_pad = ((m + block - 1) // block) * block
    ixs_p = jnp.pad(ixs_rows, ((0, m_pad - m), (0, k_pad - k)))
    # padded neighbor slots contribute 0 to both the P-weighted sum and
    # the mean numerator
    P_p = jnp.pad(P_rows, ((0, m_pad - m), (0, k_pad - k)))
    mask = (jnp.arange(k_pad) < k).astype(jnp.float32)
    d_p = jnp.pad(d_rows, ((0, m_pad - m), (0, 0)))

    def block_fn(i0):
        db = jax.lax.dynamic_slice(d_p, (i0, 0), (block, g))

        def tile_fn(carry, k0):
            est, mean_acc = carry
            ix_b = jax.lax.dynamic_slice(ixs_p, (i0, k0), (block, nt))
            P_b = jax.lax.dynamic_slice(P_p, (i0, k0), (block, nt))
            w_b = jax.lax.dynamic_slice(mask, (k0,), (nt,))
            nb = hi_rows[ix_b]                        # (B, nt, G)
            est = est + jnp.einsum("bk,bkg->bg", P_b, nb,
                                   precision=jax.lax.Precision.HIGHEST)
            mean_acc = mean_acc + jnp.einsum(
                "k,bkg->bg", w_b, nb,
                precision=jax.lax.Precision.HIGHEST)
            return (est, mean_acc), None

        init = (jnp.zeros((block, g), jnp.float32),
                jnp.zeros((block, g), jnp.float32))
        (est, mean_acc), _ = jax.lax.scan(
            tile_fn, init, jnp.arange(0, k_pad, nt))
        est = est - mean_acc / k
        num = jnp.sum(db * est, axis=-1)
        den = jnp.sqrt(jnp.sum(est * est, axis=-1))
        return num, den

    num, den = jax.lax.map(block_fn, jnp.arange(0, m_pad, block))
    return num.reshape(m_pad)[:m], den.reshape(m_pad)[:m]


_expr_scaling_compact_jit = jax.jit(_expr_scaling_compact_rows,
                                    static_argnames=("block",))


def _embedding_shift_compact(mesh, emb: np.ndarray, ixs: np.ndarray,
                             P: np.ndarray, block: int = 512) -> np.ndarray:
    """Dispatch the compact embedding shift, sharding rows over the mesh
    CELLS axis when one is given (embedding replicated)."""
    emb_j = jnp.asarray(emb, jnp.float32)
    ixs_j = jnp.asarray(ixs, jnp.int32)
    P_j = jnp.asarray(P, jnp.float32)
    if mesh is None:
        return np.asarray(_embedding_shift_compact_jit(
            emb_j, emb_j, ixs_j, P_j, block=block))
    from jax import shard_map
    from jax.sharding import PartitionSpec as SP
    from .parallel.mesh import CELLS
    n = emb.shape[0]
    shards = mesh.shape[CELLS]
    n_pad = ((n + shards - 1) // shards) * shards
    pad = n_pad - n
    fn = shard_map(functools.partial(_embedding_shift_compact_rows,
                                     block=block),
                   mesh=mesh,
                   in_specs=(SP(), SP(CELLS, None), SP(CELLS, None),
                             SP(CELLS, None)),
                   out_specs=SP(CELLS, None))
    out = fn(emb_j, jnp.pad(emb_j, ((0, pad), (0, 0))),
             jnp.pad(ixs_j, ((0, pad), (0, 0))),
             jnp.pad(P_j, ((0, pad), (0, 0))))
    return np.asarray(out[:n])


def _expr_scaling_compact(mesh, hi_rows: np.ndarray, d_rows: np.ndarray,
                          ixs: np.ndarray, P: np.ndarray, block: int = 16):
    """Dispatch the compact expression-scaling projection (optionally
    mesh-sharded over rows).  Returns (num, den) numpy vectors."""
    hi_j = jnp.asarray(hi_rows, jnp.float32)
    d_j = jnp.asarray(d_rows, jnp.float32)
    ixs_j = jnp.asarray(ixs, jnp.int32)
    P_j = jnp.asarray(P, jnp.float32)
    if mesh is None:
        num, den = _expr_scaling_compact_jit(hi_j, d_j, ixs_j, P_j,
                                             block=block)
        return np.asarray(num), np.asarray(den)
    from jax import shard_map
    from jax.sharding import PartitionSpec as SP
    from .parallel.mesh import CELLS
    n = ixs.shape[0]
    shards = mesh.shape[CELLS]
    n_pad = ((n + shards - 1) // shards) * shards
    pad = n_pad - n
    fn = shard_map(functools.partial(_expr_scaling_compact_rows,
                                     block=block),
                   mesh=mesh,
                   in_specs=(SP(), SP(CELLS, None), SP(CELLS, None),
                             SP(CELLS, None)),
                   out_specs=(SP(CELLS), SP(CELLS)))
    num, den = fn(hi_j, jnp.pad(d_j, ((0, pad), (0, 0))),
                  jnp.pad(ixs_j, ((0, pad), (0, 0))),
                  jnp.pad(P_j, ((0, pad), (0, 0))))
    return np.asarray(num[:n]), np.asarray(den[:n])


def _embedding_shift_sharded(mesh, emb: np.ndarray, P: np.ndarray,
                             K: np.ndarray, K_rowsum: np.ndarray,
                             block: int = 128) -> jax.Array:
    """Embedding shift with center rows sharded over the mesh CELLS axis
    (embedding replicated, collective-free)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as SP
    from .parallel.mesh import CELLS

    n, d = emb.shape
    shards = mesh.shape[CELLS]
    n_pad = ((n + shards - 1) // shards) * shards
    pad = n_pad - n
    emb_j = jnp.asarray(emb)
    fn = shard_map(
        functools.partial(_embedding_shift_rows, block=block),
        mesh=mesh,
        in_specs=(SP(), SP(CELLS, None), SP(CELLS, None), SP(CELLS, None),
                  SP(CELLS)),
        out_specs=SP(CELLS, None))
    out = fn(emb_j,
             jnp.pad(emb_j, ((0, pad), (0, 0))),
             jnp.pad(jnp.asarray(P), ((0, pad), (0, 0))),
             jnp.pad(jnp.asarray(K), ((0, pad), (0, 0))),
             jnp.pad(jnp.asarray(K_rowsum), ((0, pad),),
                     constant_values=1.0))
    return out[:n]


def knn_query(data: np.ndarray, query: np.ndarray, k: int):
    """kNN of query points against data (used by the grid field)."""
    from .ops.knn import _knn_query_impl
    return _knn_query_impl(data, query, k)


# ---------------------------------------------------------------------------
# module-level helpers (reference :2345-2470)
# ---------------------------------------------------------------------------

def scatter_viz(x: np.ndarray, y: np.ndarray, *args: Any, **kwargs: Any) -> Any:
    """Scatter ordered so every point stays visible (reference :2345-2376)."""
    plt = _plt()
    ix_x_sort = np.argsort(x, kind="mergesort")
    ix_yx_sort = np.argsort(y[ix_x_sort], kind="mergesort")
    args_new = []
    kwargs_new = {}
    for arg in args:
        if type(arg) is np.ndarray:
            args_new.append(arg[ix_x_sort][ix_yx_sort])
        else:
            args_new.append(arg)
    for karg, varg in kwargs.items():
        if type(varg) is np.ndarray:
            kwargs_new[karg] = varg[ix_x_sort][ix_yx_sort]
        else:
            kwargs_new[karg] = varg
    return plt.scatter(x[ix_x_sort][ix_yx_sort], y[ix_x_sort][ix_yx_sort],
                       *args_new, **kwargs_new)


def ixs_thatsort_a2b(a: np.ndarray, b: np.ndarray,
                     check_content: bool = True) -> np.ndarray:
    """Indexes that reorder array a to match array b (reference :2379-2383)."""
    if check_content:
        assert len(np.intersect1d(a, b)) == len(a), \
            "The two arrays are not matching"
    return np.argsort(a)[np.argsort(np.argsort(b))]


def _colors20():
    plt = _plt()
    return np.vstack((plt.cm.tab20b(np.linspace(0., 1, 20))[::2],
                      plt.cm.tab20c(np.linspace(0, 1, 20))[1::2]))


def colormap_fun(x: np.ndarray) -> np.ndarray:
    return _colors20()[np.mod(x, 20)]


def scale_to_match_median(sparse_matrix: sparse.csr_matrix,
                          genes_total: np.ndarray) -> sparse.csc_matrix:
    """Scale neighbor-gene weights to match median totals
    (reference :2392-2404, :2423-2446; numba loop -> vectorized numpy)."""
    data, indices, indptr = (sparse_matrix.data, sparse_matrix.indices,
                             sparse_matrix.indptr)
    new_data = np.zeros(data.shape)
    for i in range(genes_total.shape[0]):
        nz = genes_total[indices[indptr[i]:indptr[i + 1]]]
        if len(nz) == 0:
            continue
        w = np.minimum(1, np.median(nz) / nz)
        new_data[indptr[i]:indptr[i + 1]] = w * data[indptr[i]:indptr[i + 1]]
    return sparse.csc_matrix((new_data, indices, indptr),
                             shape=sparse_matrix.shape, copy=True)


def numba_random_seed(value: int) -> None:
    """Seed the host RNG used by permute_rows_nsign (the reference seeds
    numba's RNG, reference :2407-2410; we use numpy's)."""
    np.random.seed(value)


def permute_rows_nsign(A: np.ndarray) -> None:
    """In-place row permutation with random sign flips (reference :2413-2420).

    Note: the reference uses numba's RNG; the permutation sequence differs
    from the reference for the same seed, but the statistical null is the
    same (it feeds the randomized negative control only).
    """
    plmi = np.array([+1, -1])
    for i in range(A.shape[0]):
        np.random.shuffle(A[i, :])
        A[i, :] = A[i, :] * np.random.choice(plmi, size=A.shape[1])


def gaussian_kernel(X: np.ndarray, mu: float = 0, sigma: float = 1) -> np.ndarray:
    """Gaussian kernel (reference :2449-2451)."""
    return np.exp(-(X - mu) ** 2 / (2 * sigma ** 2)) / \
        np.sqrt(2 * np.pi * sigma ** 2)


def load_velocyto_hdf5(filename: str) -> "VelocytoLoom":
    """Reload a VelocytoLoom snapshot (reference :2454-2470)."""
    return load_hdf5(filename, obj_class=VelocytoLoom)
