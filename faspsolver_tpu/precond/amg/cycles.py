"""Multigrid cycle engines: V / W / hybrid, AMLI, nonlinear AMLI, FMG.

Reference: base/src/PreMGCycle.c:48 (fasp_solver_mgcycle, non-recursive
slash cycle with per-level counters), PreMGRecur.c (recursive form),
PreMGRecurAMLI.c:58/:291 (AMLI / nonlinear AMLI), PreMGCycleFull.c:47 (FMG).

Device form: the hierarchy depth and all level shapes are static, so the
cycle is *unrolled at trace time* — recursion in Python, zero control-flow
overhead at runtime, every level's kernels specialized to its shapes.  The
visit pattern (V=1 visit, W=2, hybrid VW/WV by level parity) reproduces the
reference's cycle counters (PreMGCycle.c:71-84).  W-type cycles on deep
hierarchies are capped (the traced graph grows as 2^levels) — beyond the
cap the remaining levels degrade to V-visits, which matches practical usage
(the reference's own test hierarchies are 3-7 levels deep).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ...constants import CycleType
from .hierarchy import AMGHierarchy
from .smoothers import smooth


def _sm_op(lvl):
    """Operator used inside smoother sweeps: the level's gather-free
    filtered operator when present (AMGLevel.Asm), else the exact one."""
    return lvl.A if lvl.Asm is None else lvl.Asm

# Deepest level that still doubles visits in W-type cycles.  The traced
# graph carries prod(visits) coarse-level visits, so the cap bounds trace
# size at 2^6 = 64 — the W-cycle benefit concentrates in the top levels
# while levels past the cap degrade to V-visits (they are tiny and the
# remote XLA compile path is slow; see CLAUDE.md).  Regression-checked:
# the FE-3969 golden W-cycle counts are unaffected (<= 6 levels deep).
_W_UNROLL_CAP = 6


def _visits(cycle_type: int, level: int) -> int:
    if cycle_type == CycleType.W:
        return 2 if level < _W_UNROLL_CAP else 1
    if cycle_type == CycleType.VW:       # reference hybrid 12
        return 1 if level % 2 == 0 else 2
    if cycle_type == CycleType.WV:       # reference hybrid 21
        return 2 if (level % 2 == 0 and level < _W_UNROLL_CAP) else 1
    return 1


def mgcycle(hier: AMGHierarchy, b: jax.Array,
            x: Optional[jax.Array] = None) -> jax.Array:
    """One multigrid cycle starting from iterate x (default 0)."""
    if x is None:
        x = jnp.zeros_like(b)
    return _cycle(hier, 0, b, x)


def _cycle(hier: AMGHierarchy, l: int, b, x):
    levels = hier.levels
    if l == len(levels) - 1:
        return hier.coarse(b)

    lvl = levels[l]
    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.presmooth_iter,
               forward=True)

    r = b - lvl.A(x)
    rc = lvl.R(r)

    ec = jnp.zeros(levels[l + 1].A.shape[0], dtype=b.dtype)
    for _ in range(_visits(hier.cycle_type, l)):
        ec = _cycle(hier, l + 1, rc, ec)

    if hier.coarse_scaling:
        Ae = levels[l + 1].A(ec)
        denom = jnp.dot(ec, Ae)
        alpha = jnp.minimum(
            jnp.dot(ec, rc) / jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0),
            1.0)
        ec = alpha * ec

    x = x + lvl.P(ec)
    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.postsmooth_iter,
               forward=False)
    if lvl.nk is not None:
        # extra near-kernel solve (reference: PreMGCycle.c:369-391):
        # x += B (B^T A B)^{-1} B^T (b - A x)
        rr = b - lvl.A(x)
        hi = jax.lax.Precision.HIGHEST
        x = x + jnp.dot(lvl.nk.B, jnp.dot(
            lvl.nk.Ainv, jnp.dot(lvl.nk.B.T, rr, precision=hi),
            precision=hi), precision=hi)
    return x


# ---------------------------------------------------------------------------
# AMLI (polynomial) cycle — reference: fasp_solver_amli, PreMGRecurAMLI.c:58
# ---------------------------------------------------------------------------

def amli_coefs(lambda_max: float, lambda_min: float, degree: int):
    """Chebyshev-derived AMLI polynomial coefficients
    (reference: fasp_amg_amli_coef, PreMGRecurAMLI.c:791)."""
    import math
    mu0, mu1 = 1.0 / lambda_max, 1.0 / lambda_min
    c = (math.sqrt(mu0) + math.sqrt(mu1)) ** 2
    a = (4 * mu0 * mu1) / c
    kappa = lambda_max / lambda_min
    delta = (math.sqrt(kappa) - 1.0) / (math.sqrt(kappa) + 1.0)
    bb = delta * delta
    if degree == 0:
        return (0.5 * (mu0 + mu1),)
    if degree == 1:
        return (0.5 * c, -mu0 * mu1)
    ck = list(amli_coefs(lambda_max, lambda_min, degree - 1))
    ckm1 = list(amli_coefs(lambda_max, lambda_min, degree - 2))
    coef = [0.0] * (degree + 1)
    coef[0] = a - bb * ckm1[0] + (1 + bb) * ck[0]
    for i in range(1, degree - 1):
        coef[i] = -bb * ckm1[i] + (1 + bb) * ck[i] - a * ck[i - 1]
    coef[degree - 1] = (1 + bb) * ck[degree - 1] - a * ck[degree - 2]
    coef[degree] = -a * ck[degree - 1]
    return tuple(coef)


def amli_cycle(hier: AMGHierarchy, b: jax.Array,
               x: Optional[jax.Array] = None) -> jax.Array:
    if x is None:
        x = jnp.zeros_like(b)
    return _amli(hier, 0, b, x)


def _amli(hier: AMGHierarchy, l: int, b, x):
    levels = hier.levels
    if l == len(levels) - 1:
        return hier.coarse(b)

    lvl = levels[l]
    degree = hier.amli_degree if l < _W_UNROLL_CAP else 0
    coef = hier.amli_coefs or amli_coefs(2.0, 0.5, hier.amli_degree)

    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.presmooth_iter,
               forward=True)
    r = b - lvl.A(x)
    r1 = lvl.R(r)

    A1 = levels[l + 1].A
    b1 = r1
    e1 = jnp.zeros(A1.shape[0], dtype=b.dtype)
    # polynomial acceleration (reference: PreMGRecurAMLI.c:155-170)
    for i in range(1, degree + 1):
        e1 = _amli(hier, l + 1, b1, jnp.zeros_like(e1))
        b1 = A1(e1) + (coef[degree - i] / coef[degree]) * r1
    e1 = _amli(hier, l + 1, b1, jnp.zeros_like(e1))
    e1 = coef[degree] * e1

    if hier.coarse_scaling:
        denom = jnp.dot(e1, A1(e1))
        alpha = jnp.minimum(
            jnp.dot(e1, r1) / jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0),
            1.0)
        e1 = alpha * e1

    x = x + lvl.P(e1)
    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.postsmooth_iter,
               forward=False)
    return x


# ---------------------------------------------------------------------------
# Nonlinear AMLI — reference: fasp_solver_namli, PreMGRecurAMLI.c:291
# ---------------------------------------------------------------------------

def nl_amli_cycle(hier: AMGHierarchy, b: jax.Array,
                  x: Optional[jax.Array] = None) -> jax.Array:
    if x is None:
        x = jnp.zeros_like(b)
    return _nl_amli(hier, 0, b, x)


def _nl_amli(hier: AMGHierarchy, l: int, b, x):
    """Inner Krylov acceleration per level: a few steps of minimal-residual
    (GCR-type) iteration preconditioned by the next-coarser NL-AMLI cycle
    (the reference uses FGMRES/GCG with maxit=2, KryPvfgmres on each level).
    """
    levels = hier.levels
    if l == len(levels) - 1:
        return hier.coarse(b)

    lvl = levels[l]
    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.presmooth_iter,
               forward=True)
    r = b - lvl.A(x)
    rc = lvl.R(r)

    A1 = levels[l + 1].A
    inner_steps = 2 if l + 1 < len(levels) - 1 and l < _W_UNROLL_CAP else 1
    # UA setups store per-level visit counts from the complexity rule
    # (PreAMGSetupUA.c:391-402); the reference's NL-AMLI consumes them to
    # decide plain-recursion vs inner-Krylov per level
    # (PreMGRecurAMLI.c:385)
    if hier.level_visits and l + 1 < len(hier.level_visits):
        inner_steps = min(inner_steps,
                          max(1, int(hier.level_visits[l + 1])))
    ec = jnp.zeros(A1.shape[0], dtype=b.dtype)
    rr = rc
    for _ in range(inner_steps):
        z = _nl_amli(hier, l + 1, rr, jnp.zeros_like(ec))
        Az = A1(z)
        denom = jnp.dot(Az, Az)
        alpha = jnp.dot(Az, rr) / jnp.where(denom > 1e-30, denom, 1.0)
        ec = ec + alpha * z
        rr = rr - alpha * Az

    x = x + lvl.P(ec)
    x = smooth(lvl.smoother, _sm_op(lvl), x, b, hier.postsmooth_iter,
               forward=False)
    return x


# ---------------------------------------------------------------------------
# Full multigrid — reference: fasp_solver_fmgcycle, PreMGCycleFull.c:47
# ---------------------------------------------------------------------------

def fmg_cycle(hier: AMGHierarchy, b: jax.Array) -> jax.Array:
    """Full multigrid: restrict b to the coarsest level, then interpolate
    upward running one V-cycle per level."""
    levels = hier.levels
    bs = [b]
    for lvl in levels[:-1]:
        bs.append(lvl.R(bs[-1]))

    x = hier.coarse(bs[-1])
    for l in range(len(levels) - 2, -1, -1):
        x = levels[l].P(x)
        x = _cycle(hier, l, bs[l], x)
    return x
