"""AMG hierarchy: a static-shaped pytree of levels, frozen at setup.

Reference: AMG_data (base/include/fasp.h:804-888) — per-level
{A, R, P, b, x, w, smoother data} plus a coarsest-grid solver.  Here the
hierarchy is an immutable pytree: jitting the cycle against it specializes
XLA code per hierarchy (recompiled per matrix, like the reference re-runs
setup per matrix — SURVEY.md hard-part #4).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .smoothers import SmootherData


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NearKernel:
    """Per-level near-kernel (null-space) correction data (reference:
    AMG_data.near_kernel_basis, fasp.h:849-852; per-level A_nk/P_nk/R_nk,
    PreAMGSetupUABSR.c:241-266).  B holds the restricted basis (n, m);
    Ainv = (B^T A B)^{-1} precomputed dense on host.  The cycle applies
    x += B Ainv B^T (b - A x) after post-smoothing (PreMGCycle.c:369-391)
    — two skinny dense matmuls."""

    B: jax.Array          # (n, m) restricted near-kernel basis
    Ainv: jax.Array       # (m, m)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AMGLevel:
    """One level: operator + transfers down to the next level + smoother."""

    A: Any                                # device operator (ELL/COO/BSR/Dense)
    P: Optional[Any]                      # prolongation (None on coarsest)
    R: Optional[Any]                      # restriction  (None on coarsest)
    smoother: Optional[SmootherData]      # None on coarsest
    nk: Optional[NearKernel] = None       # near-kernel correction data
    # optional gather-free SMOOTHING operator (filtered-matrix smoothing,
    # same family as the reference's SA smooth_filter, PreAMGSetupSA.c):
    # a hybrid DIA+COO level pays for its small COO remainder with
    # arbitrary-index gathers on every SpMV, and 12 of the ~14 SpMVs per
    # level per cycle are smoother applications that do not need the
    # exact operator — residuals/transfers keep A.
    Asm: Optional[Any] = None


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CoarseSolver:
    """Coarsest-grid direct solve as a dense inverse matmul.

    Reference gathers the coarsest grid into a serial direct solver
    (fasp_coarse_itsolver / UMFPACK / MUMPS, PreMGCycle.c:156-202 and
    PreAMGSetupRS.c:276-313).  Here the factorization runs on host at setup
    (in float64, like the reference's direct solvers) and the device keeps
    the inverse: the apply is one (n,n)x(n,) matmul — no on-device LU
    inside the cycle.
    """

    inv: jax.Array

    def __call__(self, b: jax.Array) -> jax.Array:
        # HIGHEST matmul precision: a default-precision f32 matmul may
        # run in TF32 (10 mantissa bits) on a GPU, which degrades the
        # coarse solve to ~3 digits and costs V-cycle iterations (the
        # level is tiny — full precision is free)
        return jnp.matmul(self.inv, b, precision=jax.lax.Precision.HIGHEST)

    @classmethod
    def from_dense(cls, mat) -> "CoarseSolver":
        mat64 = np.asarray(mat, dtype=np.float64)
        try:
            inv = np.linalg.inv(mat64)
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(mat64)
        from ...ops.operators import asdev
        return cls(inv=asdev(inv.astype(np.asarray(mat).dtype)))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class IterativeCoarseSolver:
    """Jacobi-preconditioned CG coarse solve for coarse levels too large to
    dense-factor (reference analog: fasp_coarse_itsolver, PreMGUtil.inl:25,
    which runs CG/GMRES on the coarsest grid when no direct solver is
    configured)."""

    A: Any
    dinv: jax.Array
    iters: int = dataclasses.field(metadata=dict(static=True), default=60)

    def __call__(self, b: jax.Array) -> jax.Array:
        def body(_, st):
            x, r, z, p, rz = st
            Ap = self.A(p)
            denom = jnp.dot(p, Ap)
            alpha = rz / jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = self.dinv * r
            rz_new = jnp.dot(r, z)
            beta = rz_new / jnp.where(jnp.abs(rz) > 1e-30, rz, 1.0)
            return (x, r, z, z + beta * p, rz_new)

        x0 = jnp.zeros_like(b)
        z0 = self.dinv * b
        st = (x0, b, z0, z0, jnp.dot(b, z0))
        x, *_ = jax.lax.fori_loop(0, self.iters, body, st)
        return x


# dense coarse factorization above this size is a mistake, not a solve
_DENSE_COARSE_LIMIT = 4096


def make_coarse_solver(A_host, dtype):
    """Pick the coarse-grid solver: dense LU on-device for small levels,
    Jacobi-CG for anything larger."""
    n = A_host.nrow
    if n <= _DENSE_COARSE_LIMIT:
        if hasattr(A_host, "to_csr"):
            dense = A_host.to_csr().to_dense()
        else:
            dense = A_host.to_dense()
        return CoarseSolver.from_dense(np.asarray(dense,
                                                  dtype=np.dtype(dtype)))
    from ...ops.operators import asdev, device_operator
    if hasattr(A_host, "to_csr"):
        A_csr = A_host.to_csr()
    else:
        A_csr = A_host
    d = A_csr.diagonal()
    d = np.where(d != 0.0, d, 1.0)
    return IterativeCoarseSolver(
        A=device_operator(A_csr, dtype=dtype),
        dinv=asdev(1.0 / d, dtype=dtype))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AMGHierarchy:
    """The full multilevel structure (finest at index 0)."""

    levels: Tuple[AMGLevel, ...]
    coarse: CoarseSolver
    presmooth_iter: int = dataclasses.field(metadata=dict(static=True),
                                            default=1)
    postsmooth_iter: int = dataclasses.field(metadata=dict(static=True),
                                             default=1)
    cycle_type: int = dataclasses.field(metadata=dict(static=True), default=1)
    coarse_scaling: bool = dataclasses.field(metadata=dict(static=True),
                                             default=False)
    amli_degree: int = dataclasses.field(metadata=dict(static=True),
                                         default=2)
    amli_coefs: Tuple[float, ...] = dataclasses.field(
        metadata=dict(static=True), default=())
    # per-level coarse-visit counts (1=V-like, 2=W-like), set by the UA
    # setup's complexity-based rule (reference: PreAMGSetupUA.c:391-402);
    # empty = derive visits from cycle_type alone
    level_visits: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True), default=())
    # optional float64 fine-level operator (compressed stencil form) for
    # device-resident mixed-precision refinement: the outer f64 residual
    # runs on-device (XLA-emulated f64) so refinement needs no per-round
    # host round-trips (solvers/refine.py: solve_refined_resident)
    fine64: Optional[Any] = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def complexity(self) -> Tuple[float, float]:
        """(grid complexity, operator complexity) — reference:
        fasp_amgcomplexity (AuxMessage.c)."""
        rows = [lvl.A.shape[0] for lvl in self.levels]
        nnzs = []
        for lvl in self.levels:
            a = lvl.A
            if hasattr(a, "vals"):
                nnzs.append(int(a.vals.size))
            elif hasattr(a, "mat"):
                nnzs.append(int(a.mat.size))
            else:
                nnzs.append(rows[0])
        return sum(rows) / rows[0], sum(nnzs) / max(nnzs[0], 1)
