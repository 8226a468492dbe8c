"""GMRES family: restarted / adaptive-restart / flexible, right-preconditioned.

Reference: base/src/KryPgmres.c (fixed restart), KryPvgmres.c (adaptive
restart, cr_max/cr_min rule at :79-80,:200-210), KryPvfgmres.c (flexible).
One generic core serves all three and every matrix format.

Device design choices:
- The Krylov basis lives as a dense (restart+1, n) array; orthogonalization
  is CGS2 (classical Gram-Schmidt applied twice) — two (R,n)x(n,) matmuls
  per step, in full precision, instead of the reference's
  sequential modified Gram-Schmidt loop (KryPgmres.c:199-210).  CGS2 has
  the same numerical robustness in practice and is the standard
  accelerator-side choice.
- The restart length can vary dynamically (vGMRES) without recompilation:
  the basis is allocated at restart_max (static) and the inner loop bound is
  a traced scalar.
- Givens rotations are applied via a masked fori_loop scan (scalar work,
  negligible next to the matmuls).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..constants import StopType
from .common import (SMALLREAL, basis_dot, initial_norms,
                     residual_norms, resolve_precond)
from .result import SolveResult


_CR_MAX = 0.99    # cos(8 deg)  (reference: KryPvgmres.c:79)
_CR_MIN = 0.174   # cos(80 deg) (reference: KryPvgmres.c:80)
_RESTART_MIN = 3
_RESTART_DEC = 3
# stagnation bail-out: consecutive restart cycles whose true-residual
# reduction is below _STAG_FACTOR end the solve with ERROR_SOLVER_STAG
# (-42), the GMRES analog of the reference's stagnation safeguards
# (KryUtil.inl ITS_* checks).  Without it a solve pinned at the f32
# residual floor burns the entire maxit budget inside ONE compiled
# while_loop — at maxit=2000/restart=60 a single device program that runs
# for a minute or more, which a runtime's execution watchdog may kill.
_STAG_FACTOR = 0.995
_MAX_STAG_CYCLES = 4


def gmres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
          restart=25, stop_type=int(StopType.REL_RES),
          safe: bool = False) -> SolveResult:
    """Restarted right-preconditioned GMRES (reference: fasp_solver_dcsr_pgmres)."""
    return _gmres_family(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                         adaptive=False, flexible=False, safe=safe)


def vgmres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
           restart=25, stop_type=int(StopType.REL_RES),
           safe: bool = False) -> SolveResult:
    """Adaptive-restart GMRES (reference: fasp_solver_dcsr_pvgmres)."""
    return _gmres_family(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                         adaptive=True, flexible=False, safe=safe)


def vfgmres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
            restart=25, stop_type=int(StopType.REL_RES),
            safe: bool = False) -> SolveResult:
    """Flexible GMRES with variable restart (reference:
    fasp_solver_dcsr_pvfgmres).  The preconditioner may vary per iteration
    (e.g. an inner Krylov solve), so the preconditioned basis Z is stored."""
    return _gmres_family(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                         adaptive=True, flexible=True, safe=safe)


def _gmres_family(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                  adaptive, flexible, safe=False):
    M = resolve_precond(M)
    if x0 is None:
        x0 = jnp.zeros(A.shape[0], dtype=b.dtype)
    restart = int(min(restart, maxit))
    return _gmres(A, M, jnp.asarray(b), jnp.asarray(x0),
                  jnp.asarray(tol, b.dtype), jnp.asarray(abstol, b.dtype),
                  jnp.asarray(maxit, jnp.int32), restart, stop_type,
                  adaptive, flexible, safe)


@partial(jax.jit,
         static_argnames=("R", "stop_type", "adaptive", "flexible", "safe"))
def _gmres(A, M, b, x0, tol, abstol, maxit, R: int, stop_type: int,
           adaptive: bool, flexible: bool, safe: bool = False) -> SolveResult:
    n = b.shape[0]
    dtype = b.dtype
    R1 = R + 1

    r0 = b - A(x0)
    z0 = M(r0)
    absres0, normr0, normu0, relres0 = initial_norms(stop_type, r0, z0, x0)
    already = (relres0 < tol) | (absres0 < abstol)
    r_norm0 = jnp.sqrt(jnp.dot(r0, r0))

    outer = dict(
        it=jnp.int32(0), x=x0, r=r0, r_norm=r_norm0,
        r_norm_old=r_norm0, relres=relres0, normu=normu0,
        cur_restart=jnp.int32(R), cycles=jnp.int32(0),
        done=already, status=jnp.int32(0), stag=jnp.int32(0),
        stag_best=relres0,
        best_x=x0, best_relres=relres0)

    def arnoldi_cycle(x, r, r_norm, cur_restart, it_start):
        """One restart cycle; returns (x_new, inner_steps)."""
        inv = jnp.where(r_norm > SMALLREAL, 1.0 / r_norm, 0.0)
        V = jnp.zeros((R1, n), dtype).at[0].set(r * inv)
        Z = jnp.zeros((R, n), dtype) if flexible else None
        Hrot = jnp.zeros((R1, R), dtype)
        g = jnp.zeros(R1, dtype).at[0].set(r_norm)
        cs = jnp.zeros(R, dtype)
        sn = jnp.zeros(R, dtype)

        def inner_cond(st):
            return ((st["j"] < cur_restart) & (it_start + st["j"] < maxit)
                    & (~st["brk"]))

        def inner_body(st):
            j = st["j"]
            V = st["V"]
            v = V[j]
            z = M(v)
            w = A(z)
            Zl = st["Z"].at[j].set(z) if flexible else None
            # CGS2 against V[0..j] via masked matmuls
            mask = (jnp.arange(R1) <= j).astype(dtype)
            h1 = basis_dot(V, w) * mask
            w = w - basis_dot(h1, V)
            h2 = basis_dot(V, w) * mask
            w = w - basis_dot(h2, V)
            h = h1 + h2
            hn = jnp.sqrt(jnp.dot(w, w))
            happy = hn <= SMALLREAL * 1e-8
            V = V.at[j + 1].set(w * jnp.where(happy, 0.0, 1.0 /
                                              jnp.where(happy, 1.0, hn)))

            # apply previous rotations to column h (+ the subdiagonal hn)
            def rot(k, hv):
                hk = hv[k]
                hk1 = hv[k + 1]
                nk = st["cs"][k] * hk + st["sn"][k] * hk1
                nk1 = -st["sn"][k] * hk + st["cs"][k] * hk1
                apply = k < j
                return (hv.at[k].set(jnp.where(apply, nk, hk))
                          .at[k + 1].set(jnp.where(apply, nk1, hk1)))

            hcol = h.at[jnp.minimum(j + 1, R)].set(hn)
            hcol = jax.lax.fori_loop(0, R, rot, hcol)

            # new rotation annihilating the subdiagonal
            a_, b_ = hcol[j], hcol[jnp.minimum(j + 1, R)]
            den = jnp.sqrt(a_ * a_ + b_ * b_)
            den_ok = den > SMALLREAL
            c = jnp.where(den_ok, a_ / jnp.where(den_ok, den, 1.0), 1.0)
            s = jnp.where(den_ok, b_ / jnp.where(den_ok, den, 1.0), 0.0)
            hcol = (hcol.at[j].set(c * a_ + s * b_)
                        .at[jnp.minimum(j + 1, R)].set(0.0))
            gj = st["g"][j]
            g = (st["g"].at[j].set(c * gj)
                        .at[jnp.minimum(j + 1, R)].set(-s * gj))
            res = jnp.abs(g[jnp.minimum(j + 1, R)])
            # inner convergence estimate on the least-squares residual
            conv = (res / normr0) < tol
            return dict(j=j + 1, V=V, Z=Zl,
                        Hrot=st["Hrot"].at[:, j].set(hcol),
                        g=g, cs=st["cs"].at[j].set(c),
                        sn=st["sn"].at[j].set(s),
                        brk=happy | conv)

        st0 = dict(j=jnp.int32(0), V=V, Z=Z, Hrot=Hrot, g=g, cs=cs, sn=sn,
                   brk=jnp.bool_(False))
        st = jax.lax.while_loop(inner_cond, inner_body, st0)
        j = st["j"]

        # least-squares solve: mask unused columns to identity
        cols = jnp.arange(R)
        Rmat = jnp.where(cols[None, :] < j, st["Hrot"][:R, :],
                         jnp.eye(R, dtype=dtype))
        gvec = jnp.where(cols < j, st["g"][:R], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rmat, gvec, lower=False)
        u = basis_dot(y, st["V"][:R])
        if flexible:
            dx = basis_dot(y, st["Z"])
        else:
            dx = M(u)
        return x + dx, j

    def cond(s):
        return (~s["done"]) & (s["it"] < maxit)

    def body(s):
        x, steps = arnoldi_cycle(s["x"], s["r"], s["r_norm"],
                                 s["cur_restart"], s["it"])
        it = s["it"] + steps
        # true residual each restart (doubles as the safe-guard recheck)
        r = b - A(x)
        r_norm = jnp.sqrt(jnp.dot(r, r))
        z = M(r) if stop_type == StopType.REL_PRECRES else r
        normu = jnp.maximum(SMALLREAL, jnp.sqrt(jnp.dot(x, x)))
        absres, relres = residual_norms(stop_type, r, z, normr0, normu)

        cr = r_norm / jnp.maximum(s["r_norm"], SMALLREAL)
        if adaptive:
            # reference rule (KryPvgmres.c:200-210)
            shrunk = jnp.where(s["cur_restart"] - _RESTART_DEC > _RESTART_MIN,
                               s["cur_restart"] - _RESTART_DEC, R)
            cur = jnp.where((cr > _CR_MAX) | (s["cycles"] == 0), R,
                            jnp.where(cr < _CR_MIN, s["cur_restart"], shrunk))
        else:
            cur = s["cur_restart"]

        # stagnation vs the BEST residual seen: comparing against the
        # previous cycle alone lets a wobbling plateau (0.99x, 1.01x,
        # 0.99x, ...) reset the counter forever — the floor-stalled
        # solve must IMPROVE on its best by >0.5% to stay alive
        stagnant = relres > _STAG_FACTOR * s["stag_best"]
        stag = jnp.where(stagnant, s["stag"] + 1, jnp.int32(0))
        stag_best = jnp.minimum(s["stag_best"], relres)
        # within 4x of tol the tail is allowed to crawl (a genuinely
        # slow last digit is not a floor stall)
        stalled = (stag >= _MAX_STAG_CYCLES) & (relres > 4.0 * tol)
        done = (relres < tol) | (steps == 0) | stalled
        new = dict(it=it, x=x, r=r, r_norm=r_norm, r_norm_old=s["r_norm"],
                   relres=relres,
                   normu=normu if stop_type == StopType.MOD_REL_RES
                   else s["normu"], cur_restart=cur,
                   cycles=s["cycles"] + 1, done=done,
                   status=jnp.where(stalled, jnp.int32(-42),
                                    jnp.int32(0)), stag=stag,
                   stag_best=stag_best,
                   best_x=s["best_x"], best_relres=s["best_relres"])
        if safe:
            # best-iterate tracking per restart cycle (reference:
            # KrySPgmres.c / KrySPvgmres.c safety net)
            better = relres < s["best_relres"]
            new["best_x"] = jnp.where(better, x, s["best_x"])
            new["best_relres"] = jnp.where(better, relres, s["best_relres"])
        return new

    out = jax.lax.while_loop(cond, body, outer)
    converged = out["relres"] < tol
    x_final = out["x"]
    if safe:
        use_best = (~converged) & (out["best_relres"] < out["relres"])
        x_final = jnp.where(use_best, out["best_x"], out["x"])
    return SolveResult(x=x_final, iters=out["it"], relres=out["relres"],
                       converged=converged, status=out["status"])
