"""Geometric multigrid for Poisson on structured grids, fully matrix-free.

Reference: base/src/SolGMGPoisson.c (fasp_poisson_gmg{1,2,3}d :48,:172,:308,
full-MG fgmg* :442-650, CG-accelerated gmgcg* :754-959) with stencil
kernels in base/src/PreGMG.inl (residual :34-:180, restriction2d5pt :387,
interpolation2d5pt :495, red-black GS gs2d_2color :604).

Device form: grids are dense (nx[,ny[,nz]]) arrays with one-cell zero halo;
the 2/3/5/7-point stencils are shift-adds XLA fuses into single passes;
red-black Gauss-Seidel uses checkerboard masks (the reference's own
gs2d_2color is already the parallel formulation).  The hierarchy depth is
static, so cycles unroll at trace time like the AMG cycles.

Problem convention (reference testgmg.c): -Δu = f on the unit interval/
square/cube, homogeneous Dirichlet, mesh width h = 1/n, unknowns at
interior points i=1..n-1; arrays carry the boundary so shapes are (n+1,)^d.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..krylov.result import SolveResult


# ---------------------------------------------------------------------------
# stencil kernels (d-dimensional via explicit variants)
# ---------------------------------------------------------------------------

def _laplace_2d(u, h2):
    """5-point -Δ applied to interior (zero Dirichlet halo)."""
    return (4.0 * u[1:-1, 1:-1] - u[:-2, 1:-1] - u[2:, 1:-1]
            - u[1:-1, :-2] - u[1:-1, 2:]) / h2


def _residual_2d(u, f, h2):
    r = jnp.zeros_like(u)
    return r.at[1:-1, 1:-1].set(f[1:-1, 1:-1] - _laplace_2d(u, h2))


def _rbgs_2d(u, f, h2, sweeps: int, parity_first: int = 0):
    """Red-black Gauss-Seidel (reference: gs2d_2color, PreGMG.inl:604)."""
    n0, n1 = u.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, (n0, n1), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (n0, n1), 1)
    interior = (ii > 0) & (ii < n0 - 1) & (jj > 0) & (jj < n1 - 1)
    for s in range(2 * sweeps):
        color = (ii + jj) % 2 == ((parity_first + s) % 2)
        nb = (jnp.roll(u, 1, 0) + jnp.roll(u, -1, 0)
              + jnp.roll(u, 1, 1) + jnp.roll(u, -1, 1))
        unew = (h2 * f + nb) / 4.0
        u = jnp.where(interior & color, unew, u)
    return u


def _restrict_2d(r):
    """Full-weighting restriction to the half grid."""
    c = r[2:-2:2, 2:-2:2] * 0.25 \
        + (r[1:-3:2, 2:-2:2] + r[3:-1:2, 2:-2:2]
           + r[2:-2:2, 1:-3:2] + r[2:-2:2, 3:-1:2]) * 0.125 \
        + (r[1:-3:2, 1:-3:2] + r[3:-1:2, 1:-3:2]
           + r[1:-3:2, 3:-1:2] + r[3:-1:2, 3:-1:2]) * 0.0625
    out = jnp.zeros((r.shape[0] // 2 + 1, r.shape[1] // 2 + 1), r.dtype)
    return out.at[1:-1, 1:-1].set(c)


def _prolong_2d(e, shape):
    """Bilinear interpolation to the fine grid."""
    out = jnp.zeros(shape, e.dtype)
    # even-even fine points coincide with coarse points
    out = out.at[::2, ::2].set(e)
    # odd rows / cols by averaging
    out = out.at[1:-1:2, ::2].set(0.5 * (out[:-2:2, ::2] + out[2::2, ::2]))
    out = out.at[:, 1:-1:2].set(0.5 * (out[:, :-2:2] + out[:, 2::2]))
    # re-zero the boundary
    out = out.at[0, :].set(0.0).at[-1, :].set(0.0)
    out = out.at[:, 0].set(0.0).at[:, -1].set(0.0)
    return out


def _laplace_3d(u, h2):
    return (6.0 * u[1:-1, 1:-1, 1:-1]
            - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1]
            - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1]
            - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:]) / h2


def _residual_3d(u, f, h2):
    r = jnp.zeros_like(u)
    return r.at[1:-1, 1:-1, 1:-1].set(
        f[1:-1, 1:-1, 1:-1] - _laplace_3d(u, h2))


def _rbgs_3d(u, f, h2, sweeps: int):
    n0, n1, n2 = u.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, u.shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, u.shape, 1)
    kk = jax.lax.broadcasted_iota(jnp.int32, u.shape, 2)
    interior = ((ii > 0) & (ii < n0 - 1) & (jj > 0) & (jj < n1 - 1)
                & (kk > 0) & (kk < n2 - 1))
    for s in range(2 * sweeps):
        color = (ii + jj + kk) % 2 == (s % 2)
        nb = (jnp.roll(u, 1, 0) + jnp.roll(u, -1, 0)
              + jnp.roll(u, 1, 1) + jnp.roll(u, -1, 1)
              + jnp.roll(u, 1, 2) + jnp.roll(u, -1, 2))
        unew = (h2 * f + nb) / 6.0
        u = jnp.where(interior & color, unew, u)
    return u


def _restrict_3d(r):
    # injection-weighted (trilinear full weighting via separable averages)
    a = r[1:-1, 1:-1, 1:-1]
    # average along each axis then sample
    s = r
    for ax in range(3):
        s = 0.25 * (2 * s + jnp.roll(s, 1, ax) + jnp.roll(s, -1, ax))
    c = s[2:-2:2, 2:-2:2, 2:-2:2]
    out = jnp.zeros(tuple(d // 2 + 1 for d in r.shape), r.dtype)
    return out.at[1:-1, 1:-1, 1:-1].set(c)


def _prolong_3d(e, shape):
    out = jnp.zeros(shape, e.dtype)
    out = out.at[::2, ::2, ::2].set(e)
    out = out.at[1:-1:2, ::2, ::2].set(
        0.5 * (out[:-2:2, ::2, ::2] + out[2::2, ::2, ::2]))
    out = out.at[:, 1:-1:2, ::2].set(
        0.5 * (out[:, :-2:2, ::2] + out[:, 2::2, ::2]))
    out = out.at[:, :, 1:-1:2].set(
        0.5 * (out[:, :, :-2:2] + out[:, :, 2::2]))
    for ax in range(3):
        out = out.at[tuple(0 if a == ax else slice(None)
                           for a in range(3))].set(0.0)
        out = out.at[tuple(-1 if a == ax else slice(None)
                           for a in range(3))].set(0.0)
    return out


# ---------------------------------------------------------------------------
# V-cycle engines
# ---------------------------------------------------------------------------

def _vcycle(u, f, n, dim, presm=2, postsm=2, min_n=4):
    h2 = 1.0 / (n * n)
    if dim == 2:
        lap, res, smoothf, restr, prol = (_laplace_2d, _residual_2d,
                                          _rbgs_2d, _restrict_2d,
                                          _prolong_2d)
    else:
        lap, res, smoothf, restr, prol = (_laplace_3d, _residual_3d,
                                          _rbgs_3d, _restrict_3d,
                                          _prolong_3d)
    if n <= min_n:
        return smoothf(u, f, h2, 20)
    u = smoothf(u, f, h2, presm)
    r = res(u, f, h2)
    rc = restr(r)
    ec = jnp.zeros_like(rc)
    ec = _vcycle(ec, rc, n // 2, dim, presm, postsm, min_n)
    u = u + prol(ec, u.shape)
    return smoothf(u, f, h2, postsm)


def _gmg_solve(f, n, dim, tol, maxit, full_first: bool):
    """Shared solve loop (reference: fasp_poisson_gmg2d, SolGMGPoisson.c:172;
    full-MG first sweep per fgmg*, :442-650)."""
    h2 = 1.0 / (n * n)
    res_fn = _residual_2d if dim == 2 else _residual_3d
    u = jnp.zeros_like(f)
    if full_first:
        # full multigrid initial guess: restrict f down, solve upward
        fs = [f]
        nn = n
        while nn > 4:
            fs.append((_restrict_2d if dim == 2 else _restrict_3d)(fs[-1]))
            nn //= 2
        u = jnp.zeros_like(fs[-1])
        for lvl in range(len(fs) - 1, -1, -1):
            if lvl < len(fs) - 1:
                u = (_prolong_2d if dim == 2 else _prolong_3d)(
                    u, fs[lvl].shape)
            u = _vcycle(u, fs[lvl], n >> lvl, dim)

    normb = jnp.maximum(jnp.sqrt(jnp.sum(f * f)), 1e-30)

    def body(st):
        it, u, relres = st
        u = _vcycle(u, f, n, dim)
        r = res_fn(u, f, h2)
        relres = jnp.sqrt(jnp.sum(r * r)) / normb
        return it + 1, u, relres

    def cond(st):
        it, _, relres = st
        return (relres >= tol) & (it < maxit)

    r0 = res_fn(u, f, h2)
    it, u, relres = jax.lax.while_loop(
        cond, body, (jnp.int32(0), u,
                     jnp.sqrt(jnp.sum(r0 * r0)) / normb))
    return u, it, relres


@partial(jax.jit, static_argnames=("n", "maxit", "full_first"))
def _gmg2d(f, n, tol, maxit, full_first):
    return _gmg_solve(f, n, 2, tol, maxit, full_first)


@partial(jax.jit, static_argnames=("n", "maxit", "full_first"))
def _gmg3d(f, n, tol, maxit, full_first):
    return _gmg_solve(f, n, 3, tol, maxit, full_first)


def poisson_gmg_2d(f, n: int, *, tol: float = 1e-8, maxit: int = 50,
                   full_first: bool = False) -> SolveResult:
    """Solve -Δu = f on the unit square, u=0 on boundary, (n+1)x(n+1) grid
    including boundary (reference: fasp_poisson_gmg2d)."""
    f = jnp.asarray(f)
    assert f.shape == (n + 1, n + 1)
    u, it, relres = _gmg2d(f, n, jnp.asarray(tol, f.dtype), maxit,
                           full_first)
    return SolveResult(x=u, iters=it, relres=relres,
                       converged=relres < tol, status=jnp.int32(0))


def poisson_gmg_3d(f, n: int, *, tol: float = 1e-8, maxit: int = 50,
                   full_first: bool = False) -> SolveResult:
    """Solve -Δu = f on the unit cube (reference: fasp_poisson_gmg3d)."""
    f = jnp.asarray(f)
    assert f.shape == (n + 1, n + 1, n + 1)
    u, it, relres = _gmg3d(f, n, jnp.asarray(tol, f.dtype), maxit,
                           full_first)
    return SolveResult(x=u, iters=it, relres=relres,
                       converged=relres < tol, status=jnp.int32(0))


def poisson_gmg_1d(f, n: int, *, tol: float = 1e-8, maxit: int = 50
                   ) -> SolveResult:
    """1D variant via the 2D engine on a 1-wide strip is wasteful; solve
    directly (reference: fasp_poisson_gmg1d).  n is small in practice, so a
    tridiagonal direct solve is both exact and fastest."""
    f = jnp.asarray(f)
    h2 = 1.0 / (n * n)
    # assemble tridiagonal (n-1)x(n-1) and solve on device
    main = jnp.full(n - 1, 2.0 / h2, f.dtype)
    off = jnp.full(n - 2, -1.0 / h2, f.dtype)
    A = jnp.diag(main) + jnp.diag(off, 1) + jnp.diag(off, -1)
    u_in = jnp.linalg.solve(A, f[1:-1])
    u = jnp.zeros_like(f).at[1:-1].set(u_in)
    r = f[1:-1] - (A @ u_in)
    relres = jnp.sqrt(jnp.sum(r * r)) / jnp.maximum(
        jnp.sqrt(jnp.sum(f * f)), 1e-30)
    return SolveResult(x=u, iters=jnp.int32(1), relres=relres,
                       converged=relres < tol, status=jnp.int32(0))


# ---------------------------------------------------------------------------
# CG-accelerated GMG (reference: gmgcg1/2/3d, SolGMGPoisson.c:754-959)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n", "dim", "maxit"))
def _gmgcg(f, n, dim, tol, maxit):
    """CG on the grid-function Laplacian, preconditioned by one GMG
    V-cycle per iteration."""
    h2 = 1.0 / (n * n)
    res_fn = _residual_2d if dim == 2 else _residual_3d

    def Aop(u):
        # full-grid operator: -Δu on the interior, 0 on the boundary ring
        return -res_fn(u, jnp.zeros_like(u), h2)

    def Mop(r):
        return _vcycle(jnp.zeros_like(r), r, n, dim)

    normb = jnp.maximum(jnp.sqrt(jnp.sum(f * f)), 1e-30)
    u = jnp.zeros_like(f)
    r = f - Aop(u)
    z = Mop(r)
    p = z
    rz = jnp.sum(r * z)

    def body(st):
        it, u, r, p, rz, relres = st
        Ap = Aop(p)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
        u = u + alpha * p
        r = r - alpha * Ap
        z = Mop(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) > 1e-30, rz, 1.0)
        p = z + beta * p
        relres = jnp.sqrt(jnp.sum(r * r)) / normb
        return it + 1, u, r, p, rz_new, relres

    def cond(st):
        it, _, _, _, _, relres = st
        return (relres >= tol) & (it < maxit)

    relres0 = jnp.sqrt(jnp.sum(r * r)) / normb
    it, u, r, p, rz, relres = jax.lax.while_loop(
        cond, body, (jnp.int32(0), u, r, p, rz, relres0))
    return u, it, relres


def poisson_gmgcg_2d(f, n: int, *, tol: float = 1e-8, maxit: int = 100
                     ) -> SolveResult:
    """GMG-preconditioned CG for 2D Poisson (reference: fasp_poisson_gmgcg2d,
    SolGMGPoisson.c:754)."""
    f = jnp.asarray(f)
    assert f.shape == (n + 1, n + 1)
    u, it, relres = _gmgcg(f, n, 2, jnp.asarray(tol, f.dtype), maxit)
    return SolveResult(x=u, iters=it, relres=relres,
                       converged=relres < tol, status=jnp.int32(0))


def poisson_gmgcg_3d(f, n: int, *, tol: float = 1e-8, maxit: int = 100
                     ) -> SolveResult:
    """GMG-preconditioned CG for 3D Poisson (reference: fasp_poisson_gmgcg3d,
    SolGMGPoisson.c:877)."""
    f = jnp.asarray(f)
    assert f.shape == (n + 1, n + 1, n + 1)
    u, it, relres = _gmgcg(f, n, 3, jnp.asarray(tol, f.dtype), maxit)
    return SolveResult(x=u, iters=it, relres=relres,
                       converged=relres < tol, status=jnp.int32(0))
