"""GCG and GCR: restarted full-orthogonalization descent methods.

Reference: base/src/KryPgcg.c (generalized CG) and KryPgcr.c (generalized
conjugate residual).  Both keep a window of previous directions; here the
window is a dense (restart, n) basis so orthogonalization is matmul-shaped
like the GMRES basis.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import StopType
from .common import (SMALLREAL, basis_dot, initial_norms,
                     residual_norms, resolve_precond)
from .result import SolveResult


def gcr(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
        restart=25, stop_type=int(StopType.REL_RES)) -> SolveResult:
    """Restarted GCR (reference: fasp_solver_dcsr_pgcr, KryPgcr.c)."""
    M = resolve_precond(M)
    if x0 is None:
        x0 = jnp.zeros(A.shape[0], dtype=b.dtype)
    restart = int(min(restart, maxit))
    return _gcr(A, M, jnp.asarray(b), jnp.asarray(x0),
                jnp.asarray(tol, b.dtype), jnp.asarray(abstol, b.dtype),
                jnp.asarray(maxit, jnp.int32), restart, stop_type)


def gcg(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
        restart=None, stop_type=int(StopType.REL_RES)) -> SolveResult:
    """Generalized CG (reference: fasp_solver_dcsr_pgcg, KryPgcg.c).

    The reference stores ALL MaxIt direction vectors (KryPgcg.c:70
    allocates MaxIt*m — full-memory descent, no restart; its itparam
    restart is ignored), so the default window here is the full maxit,
    capped so the two (R, n) direction buffers stay under a ~2 GB
    device-memory budget (the direction count alone does not bound
    bytes: maxit=500 at 10M dof would be 80 GB).  Pass
    ``restart`` explicitly for a smaller window.  Implemented as the
    same minimal-residual descent engine as GCR over the preconditioned
    residual directions; for SPD systems full-memory GCG coincides with
    CG in exact arithmetic (reference FE golden: GCG 243 vs CG 244
    iterations, test/out/reg.out).
    """
    if restart is None:
        budget = 2 << 30                   # bytes across P and Q buffers
        per_dir = 2 * b.shape[0] * np.dtype(
            getattr(b, "dtype", np.float64)).itemsize
        restart = max(8, min(int(maxit), 1024, budget // max(per_dir, 1)))
    return gcr(A, b, x0, M, tol=tol, abstol=abstol, maxit=maxit,
               restart=restart, stop_type=stop_type)


@partial(jax.jit, static_argnames=("R", "stop_type"))
def _gcr(A, M, b, x0, tol, abstol, maxit, R: int, stop_type: int
         ) -> SolveResult:
    n = b.shape[0]
    dtype = b.dtype

    r0 = b - A(x0)
    z0 = M(r0)
    absres0, normr0, normu0, relres0 = initial_norms(stop_type, r0, z0, x0)
    already = (relres0 < tol) | (absres0 < abstol)

    outer = dict(it=jnp.int32(0), x=x0, r=r0, relres=relres0, normu=normu0,
                 done=already, status=jnp.int32(0))

    def cycle(x, r, it_start):
        P = jnp.zeros((R, n), dtype)      # search directions
        Q = jnp.zeros((R, n), dtype)      # A @ directions (normalized)

        def inner_cond(st):
            return ((st["j"] < R) & (it_start + st["j"] < maxit)
                    & (~st["brk"]))

        def inner_body(st):
            j, x, r, P, Q = st["j"], st["x"], st["r"], st["P"], st["Q"]
            p = M(r)
            q = A(p)
            # orthogonalize q against previous Q (masked matmul, CGS2)
            mask = (jnp.arange(R) < j).astype(dtype)
            h1 = basis_dot(Q, q) * mask
            p = p - basis_dot(h1, P)
            q = q - basis_dot(h1, Q)
            h2 = basis_dot(Q, q) * mask
            p = p - basis_dot(h2, P)
            q = q - basis_dot(h2, Q)
            qn = jnp.sqrt(jnp.dot(q, q))
            brk = qn <= SMALLREAL
            inv = jnp.where(brk, 0.0, 1.0 / jnp.where(brk, 1.0, qn))
            p = p * inv
            q = q * inv
            alpha = jnp.dot(q, r)
            x = x + alpha * p
            r = r - alpha * q
            rel = jnp.sqrt(jnp.dot(r, r)) / normr0
            return dict(j=j + 1, x=x, r=r, P=P.at[j].set(p), Q=Q.at[j].set(q),
                        brk=brk | (rel < tol))

        st = jax.lax.while_loop(
            inner_cond, inner_body,
            dict(j=jnp.int32(0), x=x, r=r, P=P, Q=Q, brk=jnp.bool_(False)))
        return st["x"], st["j"]

    def cond(s):
        return (~s["done"]) & (s["it"] < maxit)

    def body(s):
        x, steps = cycle(s["x"], s["r"], s["it"])
        it = s["it"] + steps
        r = b - A(x)                       # true residual per cycle
        z = M(r) if stop_type == StopType.REL_PRECRES else r
        normu = jnp.maximum(SMALLREAL, jnp.sqrt(jnp.dot(x, x)))
        absres, relres = residual_norms(stop_type, r, z, normr0, normu)
        done = (relres < tol) | (steps == 0)
        return dict(it=it, x=x, r=r, relres=relres,
                    normu=normu if stop_type == StopType.MOD_REL_RES
                    else s["normu"], done=done, status=jnp.int32(0))

    out = jax.lax.while_loop(cond, body, outer)
    return SolveResult(x=out["x"], iters=out["it"], relres=out["relres"],
                       converged=out["relres"] < tol, status=out["status"])
