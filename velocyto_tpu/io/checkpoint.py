"""Orbax-backed checkpointing of analysis state (sharded-array aware).

The reference snapshots the whole VelocytoLoom via pickled HDF5
(velocyto/serialization.py:44-115; reproduced in
velocyto_tpu.serialization for format parity).  This module is the
device-native alternative (SURVEY.md §5): numpy/JAX arrays - including
arrays sharded over a device mesh - checkpoint through orbax, so
multi-host state saves without gathering to one host, and restore can
re-shard onto a different mesh.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np


def _checkpointer():
    import orbax.checkpoint as ocp
    return ocp.PyTreeCheckpointer()


_ARRAY_PREFIX = "arr_"
_META_KEY = "velocyto_tpu_meta"


def save_state(path: str, state: Dict[str, Any], force: bool = True) -> None:
    """Checkpoint a dict of arrays (numpy or jax, possibly sharded).

    Non-array values are stored in a small pickled side-car (they are
    host metadata - cluster labels, scalars, strings).
    """
    import pickle
    import zlib
    arrays = {}
    meta = {}
    for key, val in state.items():
        if isinstance(val, np.ndarray) or type(val).__module__.startswith(
                "jax"):
            arrays[key] = val
        else:
            meta[key] = val
    path = os.path.abspath(path)
    _checkpointer().save(path, arrays, force=force)
    with open(os.path.join(path, _META_KEY), "wb") as f:
        f.write(zlib.compress(pickle.dumps(meta)))


def load_state(path: str,
               shardings: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Restore a checkpoint.  `shardings` optionally maps array names to
    jax.sharding.Sharding objects to place arrays directly onto a mesh
    (possibly different from the one that saved them)."""
    import pickle
    import zlib
    path = os.path.abspath(path)
    restored = _checkpointer().restore(path)
    out = dict(restored)
    if shardings:
        import jax
        for key, sh in shardings.items():
            if key in out:
                out[key] = jax.device_put(out[key], sh)
    meta_path = os.path.join(path, _META_KEY)
    if os.path.exists(meta_path):
        with open(meta_path, "rb") as f:
            out.update(pickle.loads(zlib.decompress(f.read())))
    return out


def save_vlm(path: str, vlm, attributes: Optional[list] = None) -> None:
    """Checkpoint the array state of a VelocytoLoom."""
    if attributes is None:
        attributes = [k for k, v in vlm.__dict__.items()
                      if isinstance(v, np.ndarray)]
    save_state(path, {k: getattr(vlm, k) for k in attributes})


def load_vlm(path: str, vlm=None):
    """Restore arrays onto a VelocytoLoom (created bare if None)."""
    from ..analysis import VelocytoLoom
    if vlm is None:
        vlm = VelocytoLoom.__new__(VelocytoLoom)
    for k, v in load_state(path).items():
        setattr(vlm, k, v)
    return vlm
