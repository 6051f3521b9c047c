"""Reference-parity estimation API.

Thin wrappers exposing the reference function names
(velocyto/estimation.py:11-170 for colDeltaCor*, :173-389 for fit_slope*)
on top of the device kernels in velocyto_tpu.ops.  ``threads`` arguments
are accepted for signature compatibility and ignored (parallelism is the
XLA device schedule, not host threads).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .ops.coldeltacor import col_delta_cor, col_delta_cor_partial
from .ops.gamma import (fit_slope, fit_slope_offset, fit_slope_weighted,  # noqa: F401
                        fit_slope_weighted_offset, clusters_stats)


def colDeltaCor(emat: np.ndarray, dmat: np.ndarray,
                threads: Optional[int] = None) -> np.ndarray:
    return col_delta_cor(emat, dmat, "linear", 0.0)


def colDeltaCorSqrt(emat: np.ndarray, dmat: np.ndarray,
                    threads: Optional[int] = None,
                    psc: float = 0.0) -> np.ndarray:
    return col_delta_cor(emat, dmat, "sqrt", psc)


def colDeltaCorLog10(emat: np.ndarray, dmat: np.ndarray,
                     threads: Optional[int] = None,
                     psc: float = 1.0) -> np.ndarray:
    return col_delta_cor(emat, dmat, "log10", psc)


def colDeltaCorpartial(emat: np.ndarray, dmat: np.ndarray, ixs: np.ndarray,
                       threads: Optional[int] = None) -> np.ndarray:
    return col_delta_cor_partial(emat, dmat, ixs, "linear", 0.0)


def colDeltaCorSqrtpartial(emat: np.ndarray, dmat: np.ndarray,
                           ixs: np.ndarray, threads: Optional[int] = None,
                           psc: float = 0.0) -> np.ndarray:
    return col_delta_cor_partial(emat, dmat, ixs, "sqrt", psc)


def colDeltaCorLog10partial(emat: np.ndarray, dmat: np.ndarray,
                            ixs: np.ndarray, threads: Optional[int] = None,
                            psc: float = 1.0) -> np.ndarray:
    return col_delta_cor_partial(emat, dmat, ixs, "log10", psc)
