"""Distributed row-block-partitioned sparse operators over a device mesh.

This is the capability the reference does NOT have (it is OpenMP
shared-memory only — SURVEY.md §2.9): scale-out across devices via
jax.sharding.  Design (SURVEY.md §7 step 11, "How to Scale Your Model"
recipe):

- the ELL arrays are row-block sharded over a 1-D mesh axis; solution /
  rhs / residual vectors are sharded the same way;
- SpMV needs remote x entries (the "halo"): expressed as a plain gather in
  the sharded program, GSPMD turns it into the required all_gather;
  reductions in the Krylov loop (dot/norm) lower to psum collectives;
- coarse AMG levels below a size threshold are replicated (the analog of
  the reference gathering the coarse grid into a serial direct solver,
  PreMGCycle.c:156-202);
- the same Krylov/AMG code runs unchanged: distribution is a data-placement
  concern, not an algorithm rewrite.

An explicit shard_map halo-exchange SpMV (ppermute pipelining for banded
operators) lives in halo.py; this GSPMD path is the correctness
baseline.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats import CSRMatrix
from ..ops.operators import EllOperator, default_dtype


def make_mesh(n_devices: Optional[int] = None, axis: str = "rows") -> Mesh:
    """1-D device mesh over the first n_devices devices
    (the device analog of reference thread-count control,
    AuxThreads.c).  Every device reaches every other, so the mesh
    follows the row partition alone."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise RuntimeError(
            f"requested a {n}-device mesh but only {len(devs)} device(s) "
            f"visible ({devs[0].platform}); for virtual CPU devices set "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n} and "
            f"force the cpu backend BEFORE jax initializes")
    return Mesh(np.array(devs[:n]), (axis,))


def shard_rows(op: EllOperator, mesh: Mesh, axis: str = "rows"
               ) -> EllOperator:
    """Place an ELL operator's arrays row-block sharded on the mesh.

    Rows are padded to a multiple of the mesh axis size so every shard is
    equal (static shapes per device).
    """
    n_shards = mesh.shape[axis]
    n_pad = op.cols.shape[0]
    target = ((n_pad + n_shards - 1) // n_shards) * n_shards
    cols, vals = op.cols, op.vals
    if target != n_pad:
        pad = target - n_pad
        cols = jnp.pad(cols, ((0, pad), (0, 0)))
        vals = jnp.pad(vals, ((0, pad), (0, 0)))
    sh = NamedSharding(mesh, P(axis, None))
    # the sharded operator works on the PADDED square system (padded rows
    # are zero rows, so Krylov iterates keep those components at zero and
    # no reshard-inducing slice appears in the jitted program)
    return EllOperator(jax.device_put(cols, sh), jax.device_put(vals, sh),
                       target, target)


def shard_block_rows(op, mesh: Mesh, axis: str = "rows"):
    """Row-block shard a BSR block-ELL operator (block rows over the
    mesh; the x gather's cross-shard reads lower to XLA collectives —
    the GSPMD form of the SolBSR.c:349 SPE01 flow).  Block-row count
    must divide the mesh axis."""
    from ..ops.operators import BsrEllOperator
    n_shards = mesh.shape[axis]
    if op.nbrow % n_shards != 0:
        raise ValueError("nbrow must divide the mesh axis for the dryrun")
    shc = NamedSharding(mesh, P(axis, None))
    shv = NamedSharding(mesh, P(axis, None, None, None))
    return BsrEllOperator(jax.device_put(op.cols, shc),
                          jax.device_put(op.vals, shv),
                          op.nbrow, op.nbcol, op.nb)


def shard_vector(x: jax.Array, mesh: Mesh, axis: str = "rows") -> jax.Array:
    """Row-shard a vector, padding to the shard multiple."""
    n_shards = mesh.shape[axis]
    n = x.shape[0]
    target = ((n + n_shards - 1) // n_shards) * n_shards
    if target != n:
        x = jnp.pad(x, (0, target - n))
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (e.g. coarse AMG levels) on all mesh devices."""
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)


def dist_operator(A: CSRMatrix, mesh: Mesh, dtype=None,
                  axis: str = "rows") -> EllOperator:
    """Build a row-sharded device operator straight from a host matrix."""
    dtype = dtype or default_dtype()
    op = EllOperator.from_csr(A, dtype=dtype,
                              row_align=mesh.shape[axis])
    return shard_rows(op, mesh, axis)
