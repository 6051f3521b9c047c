"""Device mesh and sharding utilities.

The estimation pipeline shards along the *cells* axis (the data axis of
single-cell data) and keeps genes replicated; this is the device-mesh
replacement for the reference's single-node OpenMP parallelism over cells
(reference: velocyto/speedboosted.pyx prange loops).

Axis names:
  - "cells": data-parallel axis, sharded across devices and hosts.
  - "genes": model-ish axis, available for very wide gene panels.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CELLS = "cells"
GENES = "genes"


def make_mesh(n_cell_shards: Optional[int] = None,
              n_gene_shards: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Create a 2D (cells, genes) mesh over the available devices.

    By default all devices go on the cells axis: RNA-velocity work is
    overwhelmingly data-parallel over cells, and this keeps the heavy
    colDeltaCor / kNN collectives on the fastest axis.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if n_cell_shards is None:
        n_cell_shards = devices.size // n_gene_shards
    if n_cell_shards * n_gene_shards != devices.size:
        raise ValueError(
            f"mesh {n_cell_shards}x{n_gene_shards} does not cover {devices.size} devices")
    return Mesh(devices.reshape(n_cell_shards, n_gene_shards), (CELLS, GENES))


def single_device_mesh() -> Mesh:
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (CELLS, GENES))


def cells_sharding(mesh: Mesh, ndim: int = 2, cell_axis: int = 0) -> NamedSharding:
    """NamedSharding placing `cell_axis` on the cells mesh axis."""
    spec = [None] * ndim
    spec[cell_axis] = CELLS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for multi-host runs.

    On a single host this is a no-op.  On several hosts this must be
    called before any jax computation, with the coordinator address,
    process count and this process's id.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
