"""Preconditioner adapters: wrap AMG hierarchies (and friends) as operators
for the Krylov layer.

Reference: base/src/PreCSR.c (fasp_precond_amg :416 runs ``maxit`` mgcycles;
_amli :482; _namli :515; _famg :449) wrapping precond_data into the opaque
callback.  Here the adapter is a pytree operator, so a Krylov solver jitted
once specializes the whole preconditioned iteration into one XLA program.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..constants import CycleType
from .amg.cycles import amli_cycle, fmg_cycle, mgcycle, nl_amli_cycle
from .amg.hierarchy import AMGHierarchy


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AMGPrecond:
    """z = (approx A^{-1}) r via ``maxit`` multigrid cycles
    (reference: fasp_precond_amg, PreCSR.c:416)."""

    hier: AMGHierarchy
    maxit: int = dataclasses.field(metadata=dict(static=True), default=1)

    def __call__(self, r: jax.Array) -> jax.Array:
        cycle = {
            int(CycleType.AMLI): amli_cycle,
            int(CycleType.NL_AMLI): nl_amli_cycle,
        }.get(int(self.hier.cycle_type), mgcycle)
        z = None
        for _ in range(self.maxit):
            z = cycle(self.hier, r, z)
        return z


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AMGNKPrecond:
    """AMG preconditioner with extra near-kernel (null-space) correction
    (reference: fasp_precond_amg_nk, PreCSR.c — coarse solve over the span
    of the near-kernel basis after the multigrid cycle).

    Given a basis ``NK`` (n, m) of near-kernel vectors and the projected
    Gram matrix inverse ``gram_inv = (NKᵀ A NK)⁻¹`` precomputed at setup,
    the apply is: z = MG(r); z += NK gram_inv NKᵀ (r − A z).
    """

    hier: AMGHierarchy
    nk: jax.Array                 # (n, m) near-kernel basis
    gram_inv: jax.Array           # (m, m) = (NKᵀ A NK)⁻¹
    A_op: object                  # fine-level operator (pytree callable)
    maxit: int = dataclasses.field(metadata=dict(static=True), default=1)

    def __call__(self, r: jax.Array) -> jax.Array:
        z = AMGPrecond(self.hier, maxit=self.maxit)(r)
        resid = r - self.A_op(z)
        hi = jax.lax.Precision.HIGHEST
        coeffs = jnp.dot(self.gram_inv, jnp.dot(self.nk.T, resid,
                                                precision=hi), precision=hi)
        return z + jnp.dot(self.nk, coeffs, precision=hi)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FMGPrecond:
    """Full-multigrid preconditioner (reference: fasp_precond_famg,
    PreCSR.c:449)."""

    hier: AMGHierarchy
    maxit: int = dataclasses.field(metadata=dict(static=True), default=1)

    def __call__(self, r: jax.Array) -> jax.Array:
        z = fmg_cycle(self.hier, r)
        for _ in range(self.maxit - 1):
            z = mgcycle(self.hier, r, z)
        return z
