"""Preconditioner operators usable inside jitted Krylov loops.

Reference: the opaque ``precond{void* data; void (*fct)(...)}`` callback
(base/include/fasp.h:1095-1103) — here a preconditioner is any pytree with
``__call__(r) -> z``.  Simple ones live here; AMG/ILU/Schwarz preconditioners
live in faspsolver_tpu.precond.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class IdentityPrecond:
    """No preconditioning (reference: precond_type NONE)."""

    def __call__(self, r: jax.Array) -> jax.Array:
        return r


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class JacobiPrecond:
    """Diagonal (Jacobi) preconditioner (reference: fasp_precond_diag,
    PreCSR.c:172)."""

    dinv: jax.Array

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.dinv * r

    @classmethod
    def from_csr(cls, A, dtype=None) -> "JacobiPrecond":
        from ..ops.operators import default_dtype
        dtype = dtype or default_dtype()
        d = A.diagonal()
        return cls(jnp.asarray(np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d),
                                        1.0), dtype=dtype))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockJacobiPrecond:
    """Block-diagonal preconditioner with precomputed block inverses
    (reference: fasp_precond_dbsr_diag, PreBSR.c:49)."""

    dinv: jax.Array          # (nbrow, nb, nb)

    def __call__(self, r: jax.Array) -> jax.Array:
        nb = self.dinv.shape[1]
        rb = r.reshape(-1, nb)
        return jnp.einsum("nab,nb->na", self.dinv, rb,
                          precision=jax.lax.Precision.HIGHEST).reshape(-1)

    @classmethod
    def from_bsr(cls, A, dtype=None) -> "BlockJacobiPrecond":
        from ..ops.operators import default_dtype
        dtype = dtype or default_dtype()
        return cls(jnp.asarray(A.diag_inv(), dtype=dtype))
