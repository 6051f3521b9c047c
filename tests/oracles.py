"""Literal numpy oracles for the numerical semantics under test.

These are straight transliterations of the *mathematical definitions*
extracted from the reference (see docstrings in velocyto_tpu.ops.*); they
are deliberately slow and simple so the device kernels can be validated
against them.
"""
import numpy as np


def transform_delta(delta, transform, psc, partial):
    if transform == "linear":
        return delta
    if transform == "sqrt":
        mag = np.sqrt(np.abs(delta) + psc)
        out = np.where(delta > 0, mag, -mag)
        if partial:
            out = np.where(np.abs(delta) < 1e-16, 0.0, out)
        return out
    if transform == "log10":
        mag = np.log10(np.abs(delta) + psc)
        if partial:
            return np.where(delta >= 0, mag, -mag)
        return np.where(delta > 0, mag, -mag)
    raise ValueError(transform)


def col_delta_cor_dense(emat, dmat, transform="linear", psc=0.0,
                        centres=None):
    """For each cell c: corr(transform(e[:,i]-e[:,c]), d[:,c]).  With
    `centres`, only those rows (in that order)."""
    g, n = emat.shape
    centres = range(n) if centres is None else centres
    out = np.zeros((len(centres), n))
    for r, c in enumerate(centres):
        a = transform_delta(emat - emat[:, c][:, None], transform, psc,
                            partial=False)
        a_c = a - a.mean(0)[None, :]
        b = dmat[:, c]
        b_c = b - b.mean()
        num = a_c.T @ b_c
        den = np.sqrt((a_c ** 2).sum(0)) * np.sqrt((b_c ** 2).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            out[r, :] = num / den
    return out


def col_delta_cor_partial(emat, dmat, ixs, transform="linear", psc=0.0):
    """Row c: corr(transform(e[:,ixs[c]]-e[:,c]), d[:,c]) for the first
    len(ixs) cells (ixs may hold the rows of a prefix of the cells)."""
    nn = ixs.shape[1]
    out = np.zeros((ixs.shape[0], nn))
    for c in range(ixs.shape[0]):
        cols = ixs[c]
        a = transform_delta(emat[:, cols] - emat[:, c][:, None], transform,
                            psc, partial=True)
        a_c = a - a.mean(0)[None, :]
        b = dmat[:, c]
        b_c = b - b.mean()
        num = a_c.T @ b_c
        den = np.sqrt((a_c ** 2).sum(0)) * np.sqrt((b_c ** 2).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            out[c, :] = num / den
    return out
