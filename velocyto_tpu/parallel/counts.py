"""Distributed count-matrix merge.

The reference's counting is single-process and simply concatenates cell
batches (velocyto/commands/_run.py:284-297).  Across devices, feeder
hosts count disjoint read shards of the SAME cells (e.g. one BAM chunk
per host of a position-split file, or lane-split FASTQ-derived BAMs):
their per-(gene, cell) partial counts must be summed.  This module does
that merge as a `shard_map` psum over the mesh, within a host and
across hosts.

For the complementary layout - hosts own disjoint CELL ranges of a
cell-sorted BAM - no collective is needed: columns concatenate, which is
what `ExInCounter.count` + loom assembly already do per host.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:              # older jax
    from jax.experimental.shard_map import shard_map

from .mesh import CELLS, GENES


def merge_feeder_counts(mesh: Mesh, stacked: jax.Array) -> jax.Array:
    """Merge a (n_feeders, genes, cells) stack of partial counts into the
    (genes, cells) total, with the feeder axis sharded over the mesh's
    cells axis so each device reduces its local stack slice and a psum
    combines across devices."""
    n_dev = mesh.devices.size
    n_feeders = stacked.shape[0]
    pad = (-n_feeders) % n_dev
    if pad:
        stacked = jnp.concatenate(
            [stacked, jnp.zeros((pad,) + stacked.shape[1:], stacked.dtype)])
    sharding = NamedSharding(mesh, P((CELLS, GENES), None, None))
    stacked = jax.device_put(stacked, sharding)

    @jax.jit
    def run(s):
        def body(shard):                      # (n_feeders/n_dev, g, c)
            local = jnp.sum(shard, axis=0)
            return jax.lax.psum(local, (CELLS, GENES))[None]
        out = shard_map(body, mesh=mesh,
                        in_specs=P((CELLS, GENES), None, None),
                        out_specs=P((CELLS, GENES), None, None))(s)
        return out[0]

    return run(stacked)


def merge_feeder_counts_np(partials: np.ndarray) -> np.ndarray:
    """Host reference implementation (sum over the feeder axis)."""
    return np.sum(partials, axis=0)
