"""velocyto_tpu: an RNA-velocity framework on JAX.

Two pipelines sharing one package (mirroring the reference's structure,
velocyto-team/velocyto.py, but re-designed for JAX/XLA accelerators):

  - counting:  BAM + GTF -> 4-layer .loom of spliced/unspliced/ambiguous
               molecule counts (velocyto_tpu.counting, velocyto_tpu.commands)
  - estimation: .loom -> velocity field on an embedding
               (velocyto_tpu.analysis; device kernels in velocyto_tpu.ops)

The loom file on disk is the contract between the halves.
"""
from ._version import __version__
from .constants import *  # noqa: F401,F403

import os as _os

# glibc malloc tuning: both pipelines cycle through many multi-hundred-MB
# numpy arrays.  By default glibc serves those from fresh mmaps, so every
# one pays first-touch page faults (measured as low as ~60 MB/s on some
# virtualized hosts — a single (2k, 20k) f64 elementwise expression cost
# 15 s).  Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD keeps freed blocks on
# the heap for reuse (same computation: 0.2 s on later passes).  Trades
# retained RSS for throughput; opt out with VELOCYTO_NO_MALLOC_TUNE=1.
if not _os.environ.get("VELOCYTO_NO_MALLOC_TUNE"):
    try:
        import ctypes as _ctypes

        _libc = _ctypes.CDLL("libc.so.6", use_errno=True)
        _libc.mallopt(-3, 1 << 30)      # M_MMAP_THRESHOLD
        _libc.mallopt(-1, 1 << 30)      # M_TRIM_THRESHOLD
    except Exception:
        pass

import jax as _jax

# Honor explicitly-requested 64-bit dtypes (the device-resident exact
# kNN re-score runs in f64 on device) without flipping global x64
# promotion semantics for everything else.
_jax.config.update("jax_explicit_x64_dtypes", "allow")

# Persistent XLA compilation cache.  When JAX_COMPILATION_CACHE_DIR is
# set, JAX reads it itself and the package sets nothing; otherwise
# compiled programs go to one fixed directory beside the package, so
# every process of a checkout shares them.
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if _os.environ.get("JAX_COMPILATION_CACHE_DIR") is None:
    _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

from .ops import (col_delta_cor, col_delta_cor_partial,
                  col_delta_cor_partial_compact, col_delta_cor_partial_sharded,
                  knn_search, knn_balance, balance_knn_loop, BalancedKNN,
                  knn_distance_matrix, make_mutual, take_top, min_n,
                  knn_smooth_weights,
                  connectivity_to_weights, convolve_by_sparse_weights,
                  fit_slope, fit_slope_offset, fit_slope_weighted,
                  fit_slope_weighted_offset, clusters_stats, PCA)
from .parallel import (CELLS, GENES, make_mesh, single_device_mesh,
                       initialize_distributed)

# Reference-parity API (estimation.py names, velocyto/estimation.py:11-170)
from .estimation import (colDeltaCor, colDeltaCorSqrt, colDeltaCorLog10,
                         colDeltaCorpartial, colDeltaCorSqrtpartial,
                         colDeltaCorLog10partial)
from .serialization import dump_hdf5, load_hdf5
from .diffusion import Diffusion
from .metadata import Metadata, MetadataCollection
from .analysis import (VelocytoLoom, load_velocyto_hdf5, scatter_viz,
                       ixs_thatsort_a2b, gaussian_kernel, colormap_fun,
                       scale_to_match_median, permute_rows_nsign,
                       numba_random_seed)
from . import io

from .counting import (Logic, Permissive10X, Intermediate10X,
                       ValidatedIntrons10X, Stricter10X, ObservedSpanning10X,
                       Discordant10X, SmartSeq2, Default, LOGICS,
                       Feature, TranscriptModel, GeneInfo, Read,
                       Molitem, SegmentMatch, ExInCounter)
