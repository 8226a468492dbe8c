"""Block-composite (BLC) preconditioners.

Reference: base/src/PreBLC.c — block-diagonal / block-lower / block-upper /
block-SGS preconditioners for 2x2..4x4 coupled systems, with AMG (or
diagonal) approximations of the diagonal blocks, plus the layered
"sweeping" preconditioner for Helmholtz-type block-tridiagonal systems
(fasp_precond_dblc_sweeping, data struct fasp_block.h:398-414).

Device form: each sub-block becomes a device operator; diagonal-block
inverses are AMG hierarchies (the same gather-free machinery as the scalar
path) or Jacobi; the block structure is unrolled at trace time, so a
block-preconditioned Krylov iteration is still one XLA program.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSRMatrix
from ..formats.blc import BLCMatrix
from ..ops.operators import default_dtype, device_operator
from ..utils.params import AMGParam


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlcOperator:
    """Device operator for a matrix-of-blocks: y_i = sum_j A_ij x_j
    (reference: fasp_blas_dblc_aAxpy, BlaSpmvBLC.c)."""

    ops: Tuple[Tuple[object, ...], ...]       # brow x bcol; None = zero
    row_sizes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    col_sizes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (sum(self.row_sizes), sum(self.col_sizes))

    @property
    def dtype(self):
        for row in self.ops:
            for op in row:
                if op is not None:
                    return op.dtype
        return None

    def _split(self, x, sizes):
        out, off = [], 0
        for s in sizes:
            out.append(jax.lax.slice(x, (off,), (off + s,)))
            off += s
        return out

    def __call__(self, x: jax.Array) -> jax.Array:
        xs = self._split(x, self.col_sizes)
        ys = []
        for i, row in enumerate(self.ops):
            acc = jnp.zeros(self.row_sizes[i], dtype=x.dtype)
            for j, op in enumerate(row):
                if op is not None:
                    acc = acc + op(xs[j])
            ys.append(acc)
        return jnp.concatenate(ys)

    @classmethod
    def from_blc(cls, A: BLCMatrix, dtype=None) -> "BlcOperator":
        dtype = dtype or default_dtype()
        ops = tuple(
            tuple(device_operator(b, dtype=dtype) if b is not None else None
                  for b in row)
            for row in A.blocks)
        return cls(ops=ops, row_sizes=tuple(A.row_sizes()),
                   col_sizes=tuple(A.col_sizes()))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _JacobiApply:
    """Diagonal (Jacobi) approximate block inverse as a pytree callable."""

    dinv: jax.Array

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.dinv * r


def _diag_solver(block: CSRMatrix, kind: str, amg: Optional[AMGParam],
                 dtype):
    """Approximate inverse of one diagonal block: 'amg' | 'diag'."""
    if kind == "diag" or block.nrow <= 64:
        d = block.diagonal()
        d = np.where(d != 0.0, d, 1.0)
        return _JacobiApply(jnp.asarray(1.0 / d, dtype=dtype))
    from .amg.setup_ua import setup_ua
    from .preconditioners import AMGPrecond
    hier = setup_ua(block, amg or AMGParam(), dtype=dtype)
    return AMGPrecond(hier)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlcPrecond:
    """Block diag/lower/upper/SGS preconditioner (reference: PreBLC.c
    fasp_precond_dblc_diag_/lower_/upper_/sgs_{2,3,4}).

    ``solvers`` / ``offdiag`` are pytree children (they hold device
    arrays); the block layout itself is static.
    """

    solvers: Tuple[object, ...]
    offdiag: Tuple[Tuple[object, ...], ...]    # device ops; None = zero
    mode: str = dataclasses.field(metadata=dict(static=True))  # diag|lower|upper|sgs
    sizes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    def _split(self, r):
        out, off = [], 0
        for s in self.sizes:
            out.append(jax.lax.slice(r, (off,), (off + s,)))
            off += s
        return out

    def _gs(self, rs, zs, order):
        """Block GS updates in the given order using the current iterate:
        z_i <- M_i^{-1}(r_i - sum_{j != i} A_ij z_j)."""
        nb = len(self.sizes)
        for i in order:
            acc = rs[i]
            for j in range(nb):
                op = self.offdiag[i][j]
                if j != i and op is not None and zs[j] is not None:
                    acc = acc - op(zs[j])
            zs[i] = self.solvers[i](acc)
        return zs

    def __call__(self, r: jax.Array) -> jax.Array:
        rs = self._split(r)
        nb = len(self.sizes)
        if self.mode == "diag":
            zs = [self.solvers[i](rs[i]) for i in range(nb)]
        elif self.mode == "lower":
            zs = self._gs(rs, [None] * nb, range(nb))
        elif self.mode == "upper":
            zs = self._gs(rs, [None] * nb, range(nb - 1, -1, -1))
        else:                                   # sgs: forward then backward
            zs = self._gs(rs, [None] * nb, range(nb))
            zs = self._gs(rs, zs, range(nb - 1, -1, -1))
        return jnp.concatenate(zs)


def setup_blc_precond(A: BLCMatrix, mode: str = "diag",
                      diag_solver: str = "amg",
                      amg: Optional[AMGParam] = None,
                      dtype=None) -> BlcPrecond:
    """Build a block preconditioner; diagonal blocks get AMG (or Jacobi)
    approximate inverses (reference: fasp_precond_dblc_diag_3_amg etc.)."""
    dtype = dtype or default_dtype()
    nb = A.brow
    if nb != A.bcol:
        raise ValueError("block preconditioner needs a square block grid")
    solvers = tuple(_diag_solver(A.blocks[i][i], diag_solver, amg, dtype)
                    for i in range(nb))
    offdiag = tuple(
        tuple((device_operator(A.blocks[i][j], dtype=dtype)
               if (i != j and A.blocks[i][j] is not None) else None)
              for j in range(nb))
        for i in range(nb))
    return BlcPrecond(solvers=solvers, offdiag=offdiag, mode=mode,
                      sizes=tuple(A.row_sizes()))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlcSweepingPrecond:
    """Layered sweeping preconditioner for block-tridiagonal systems
    (reference: fasp_precond_dblc_sweeping, PreBLC.c; data
    fasp_block.h:398-414).  Forward elimination with per-layer approximate
    solves, then backward substitution."""

    solvers: Tuple[object, ...]
    lower: Tuple[object, ...]          # sub-diagonal ops; None = zero
    upper: Tuple[object, ...]          # super-diagonal ops; None = zero
    sizes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    def __call__(self, r: jax.Array) -> jax.Array:
        nb = len(self.sizes)
        rs, off = [], 0
        for s in self.sizes:
            rs.append(jax.lax.slice(r, (off,), (off + s,)))
            off += s
        # forward sweep
        zs = [None] * nb
        zs[0] = self.solvers[0](rs[0])
        for i in range(1, nb):
            acc = rs[i]
            if self.lower[i - 1] is not None:
                acc = acc - self.lower[i - 1](zs[i - 1])
            zs[i] = self.solvers[i](acc)
        # backward sweep
        for i in range(nb - 2, -1, -1):
            if self.upper[i] is not None:
                zs[i] = zs[i] - self.solvers[i](self.upper[i](zs[i + 1]))
        return jnp.concatenate(zs)


def setup_blc_sweeping(A: BLCMatrix, diag_solver: str = "amg",
                       amg: Optional[AMGParam] = None,
                       dtype=None) -> BlcSweepingPrecond:
    dtype = dtype or default_dtype()
    nb = A.brow
    for i in range(nb):
        for j in range(nb):
            if abs(i - j) > 1 and A.blocks[i][j] is not None:
                raise ValueError("sweeping preconditioner needs a "
                                 "block-tridiagonal system")
    solvers = tuple(_diag_solver(A.blocks[i][i], diag_solver, amg, dtype)
                    for i in range(nb))
    lower = tuple(device_operator(A.blocks[i + 1][i], dtype=dtype)
                  if A.blocks[i + 1][i] is not None else None
                  for i in range(nb - 1))
    upper = tuple(device_operator(A.blocks[i][i + 1], dtype=dtype)
                  if A.blocks[i][i + 1] is not None else None
                  for i in range(nb - 1))
    return BlcSweepingPrecond(solvers=solvers, lower=lower, upper=upper,
                              sizes=tuple(A.row_sizes()))
