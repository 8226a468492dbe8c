"""Distributed banded (DIA) operators and sharded AMG hierarchies.

The gather-free structured path distributes naturally: a banded SpMV's
statically-shifted reads touch at most ``max|offset|`` remote entries per
shard boundary, so under GSPMD the row-block-sharded DIA SpMV lowers to a
neighbor halo exchange (collective-permute) plus purely local
shifted multiply-adds — the textbook distributed stencil pattern
(SURVEY.md §7 step 11).  Krylov reductions lower to psum.

Coarse AMG levels below a size threshold are replicated — the analog of
the reference gathering the coarsest grid into one serial direct solver
(PreMGCycle.c:156-202).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats import CSRMatrix
from ..ops.operators import DiaOperator, default_dtype, dia_bands_from_csr


def dist_dia_operator(A: CSRMatrix, mesh: Mesh, dtype=None,
                      axis: str = "rows") -> DiaOperator:
    """Row-block-sharded DIA operator from a host matrix.  Rows are padded
    to a multiple of the mesh axis (padded rows are zero)."""
    dtype = dtype or default_dtype()
    offsets, bands = dia_bands_from_csr(A)
    n = A.nrow
    nsh = mesh.shape[axis]
    target = ((n + nsh - 1) // nsh) * nsh
    if target != n:
        bands = np.pad(bands, ((0, 0), (0, target - n)))
    sh = NamedSharding(mesh, P(None, axis))
    dev = jax.device_put(jnp.asarray(bands.astype(np.dtype(dtype))), sh)
    return DiaOperator(dev, tuple(int(o) for o in offsets), target)


def shard_hierarchy(hier, mesh: Mesh, axis: str = "rows",
                    min_size: int = 8192):
    """Place an AMG hierarchy on a mesh: large per-level arrays row-block
    sharded (last axis), small/coarse arrays replicated.

    Only shards arrays whose last dimension is divisible by the mesh axis
    size — everything else replicates, so the cycle stays correct for any
    problem size (just without scale-out on the odd-shaped pieces).
    """
    nsh = mesh.shape[axis]
    repl = NamedSharding(mesh, P())

    def place(a):
        if (hasattr(a, "ndim") and a.ndim >= 1
                and a.shape[-1] >= min_size and a.shape[-1] % nsh == 0):
            spec = P(*([None] * (a.ndim - 1) + [axis]))
            return jax.device_put(a, NamedSharding(mesh, spec))
        return jax.device_put(a, repl)

    return jax.tree_util.tree_map(place, hier)
