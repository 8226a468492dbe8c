"""Mixed-precision iterative refinement: f32 device solves, f64 accuracy.

f32 halves the bytes every memory-bound kernel moves against f64.  The
classic way to keep f64 accuracy anyway — the performance mode suggested
by SURVEY.md hard-part #5 — is iterative refinement: an outer f64 loop
computes true residuals and accumulates the solution; the inner Krylov
solve runs entirely on device in f32.  Each round multiplies the achieved
accuracy, so 2-3 rounds of an inner 1e-5 solve reach 1e-10 — far below
anything f32 alone can do.

The reference is double-precision throughout (REAL=double, fasp.h:75);
this module matches that accuracy with an f32 hot loop.  Whether f32 +
refinement beats f64 throughout on a given card is ROADMAP S7.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..formats import BSRMatrix, CSRMatrix


@dataclass
class RefinedResult:
    x: np.ndarray               # f64 solution
    rounds: int                 # outer refinement rounds used
    inner_iters: int            # total inner Krylov iterations
    relres: float               # true f64 relative residual
    converged: bool


def solve_refined(A_host, b, inner_solve: Callable,
                  *, tol: float = 1e-8, max_rounds: int = 6,
                  inner_tol: float = 1e-5, inner_floor: float = 5e-6,
                  dtype=jnp.float32) -> RefinedResult:
    """Outer f64 refinement around an inner reduced-precision solver.

    ``A_host`` is a host matrix (CSRMatrix/BSRMatrix) used for exact f64
    residuals; ``inner_solve(r_device, tol) -> SolveResult`` solves
    A d = r approximately on device (e.g. AMG-PCG in f32).  The inner
    tolerance adapts: each round only requests the remaining reduction
    (times a safety factor), clamped to the f32 floor, so late rounds cost
    a couple of iterations instead of a full solve.
    """
    if isinstance(A_host, BSRMatrix):
        spmv = A_host.matvec
    elif isinstance(A_host, CSRMatrix):
        spmv = A_host.matvec
    else:
        raise TypeError("solve_refined needs a host matrix for f64 residuals")

    b64 = np.asarray(b, dtype=np.float64)
    bnorm = max(float(np.linalg.norm(b64)), 1e-300)
    x = np.zeros_like(b64)
    total_inner = 0
    relres = 1.0
    prev_relres = np.inf
    slow_rounds = 0
    best_x, best_relres = x, np.inf
    for rnd in range(max_rounds):
        r = b64 - spmv(x)
        relres = float(np.linalg.norm(r)) / bnorm
        if relres < best_relres:
            best_x, best_relres = x, relres
        if relres < tol:
            return RefinedResult(x=x, rounds=rnd, inner_iters=total_inner,
                                 relres=relres, converged=True)
        # stall guard: refinement converges geometrically when it works
        # (each round multiplies the error by the inner solve's residual
        # reduction).  TWO CONSECUTIVE rounds gaining less than 2x while
        # still more than 10x away from tol mean the inner precision
        # budget is exhausted (conditioning beyond ~1/eps_f32) — further
        # rounds repeat the same stalled correction, so stop early and
        # return the BEST iterate seen (a diverged inner correction must
        # not be handed back).  One slow round alone is NOT a stall: a
        # steady ~1.9x/round refinement must be allowed to continue.
        # Within 10x of tol the remaining rounds may crawl
        # across the finish line.
        if relres > 0.5 * prev_relres and relres > 10 * tol:
            slow_rounds += 1
            if slow_rounds >= 2:
                return RefinedResult(x=best_x, rounds=rnd,
                                     inner_iters=total_inner,
                                     relres=best_relres, converged=False)
        else:
            slow_rounds = 0
        prev_relres = relres
        # scale the residual to O(1) so the f32 inner solve keeps dynamic
        # range, then scale the correction back
        scale = max(float(np.abs(r).max()), 1e-300)
        need = max(min(inner_tol, 0.3 * tol / relres), inner_floor)
        res = inner_solve(jnp.asarray(r / scale, dtype=dtype), need)
        total_inner += int(res.iters)
        x = x + scale * np.asarray(res.x, dtype=np.float64)
    r = b64 - spmv(x)
    relres = float(np.linalg.norm(r)) / bnorm
    if relres > best_relres:               # last round made things worse
        x, relres = best_x, best_relres
    return RefinedResult(x=x, rounds=max_rounds, inner_iters=total_inner,
                         relres=relres, converged=relres < tol)


def solve_refined_device(op_hi, b, inner_solve: Callable,
                         *, tol: float = 1e-8, max_rounds: int = 6,
                         inner_tol: float = 1e-5, inner_floor: float = 5e-6,
                         dtype=jnp.float32) -> RefinedResult:
    """Device-resident refinement: the f64 operator, solution, and
    residuals all live on device, so each round costs one emulated-f64
    SpMV and two scalar readbacks instead of host<->device vector
    round-trips.

    ``op_hi`` must be a high-precision (f64) device operator; requires
    jax_enable_x64.  ``inner_solve(r32, tol) -> SolveResult`` as in
    :func:`solve_refined`.
    """
    import jax

    @jax.jit
    def resid(x):
        r = b64 - op_hi(x)
        return r, jnp.sqrt(jnp.vdot(r, r)), jnp.max(jnp.abs(r))

    b64 = jnp.asarray(np.asarray(b), dtype=jnp.float64)
    bnorm = max(float(jnp.sqrt(jnp.vdot(b64, b64))), 1e-300)
    x = jnp.zeros_like(b64)
    total_inner = 0
    relres = 1.0
    for rnd in range(max_rounds):
        r, rn, scale = resid(x)
        relres = float(rn) / bnorm
        if relres < tol:
            return RefinedResult(x=np.asarray(x), rounds=rnd,
                                 inner_iters=total_inner, relres=relres,
                                 converged=True)
        need = max(min(inner_tol, 0.3 * tol / relres), inner_floor)
        res = inner_solve((r / scale).astype(dtype), need)
        total_inner += int(res.iters)
        x = x + scale * res.x.astype(jnp.float64)
    r, rn, _ = resid(x)
    relres = float(rn) / bnorm
    return RefinedResult(x=np.asarray(x), rounds=max_rounds,
                         inner_iters=total_inner, relres=relres,
                         converged=relres < tol)


def make_resident_refiner(op64, op32, M, *, tol: float = 1e-6,
                          max_rounds: int = 4, inner_tol: float = 1e-5,
                          inner_floor: float = 5e-6, maxit_inner: int = 40):
    """Build ONE jitted device program that runs the whole refinement.

    Per round (all on device, zero host round-trips):
    f64 true residual via ``op64`` (XLA-emulated f64 — cheap once per
    round, and with a compressed stencil operator it costs no extra
    coefficient memory) -> scale -> f32 AMG-PCG inner solve -> f64 solution
    update.  The loop exits when the on-device f64 relative residual drops
    below ``tol``.

    This is the latency-robust form of :func:`solve_refined`: the host-loop
    version pays a transfer and a readback per round; here the solve is
    one dispatch + one final x readback.
    Requires jax_enable_x64.
    """
    import jax

    tol_ = float(tol)
    fn = _resident_refine_fn(tol_, float(inner_tol), float(inner_floor),
                             int(max_rounds), int(maxit_inner))

    def run(b64):
        return fn(op64, op32, M, b64)

    def _compile(b_spec):
        """AOT-compile for a b of the given ShapeDtypeStruct; returns a
        callable taking b only (operators bound)."""
        ex = fn.lower(op64, op32, M, b_spec).compile()
        return lambda b64: ex(op64, op32, M, b64)

    run.compile = _compile
    return run


def _refine_body(op64, op32, M, b64, tol_, inner_tol, inner_floor,
                 max_rounds, maxit_inner):
    """Traced refinement loop (shared by the arg-passing and packed
    jitted wrappers)."""
    import jax
    from ..krylov import pcg

    bnorm = jnp.maximum(jnp.sqrt(jnp.vdot(b64, b64)), 1e-300)
    x0 = jnp.zeros_like(b64)
    state = dict(x=x0, r=b64, relres=jnp.asarray(1.0, b64.dtype),
                 rnd=jnp.int32(0), iters=jnp.int32(0))

    def cond(s):
        return (s["relres"] >= tol_) & (s["rnd"] < max_rounds)

    def body(s):
        r = s["r"]
        scale = jnp.maximum(jnp.max(jnp.abs(r)), 1e-300)
        need = jnp.clip(0.3 * tol_ / jnp.maximum(s["relres"], 1e-300),
                        inner_floor, inner_tol)
        r32 = (r / scale).astype(op32.dtype)
        # tight safeguard budgets: when the inner f32 solve hits its
        # residual floor (catastrophic cancellation in b - Ax for systems
        # whose solution amplitude >> rhs amplitude, e.g. FE loads ~h^2),
        # Check II/III restarts would otherwise burn ~20 dead iterations
        # per round before bailing — the outer f64 loop IS the recovery
        # mechanism here, so give up after 2 restarts and hand back
        res = pcg(op32, r32, M=M, tol=need.astype(r32.dtype),
                  maxit=maxit_inner, max_stag=2, max_restart=2)
        x = s["x"] + scale * res.x.astype(b64.dtype)
        rn = b64 - op64(x)
        relres = jnp.sqrt(jnp.vdot(rn, rn)) / bnorm
        return dict(x=x, r=rn, relres=relres, rnd=s["rnd"] + 1,
                    iters=s["iters"] + res.iters.astype(jnp.int32))

    out = jax.lax.while_loop(cond, body, state)
    return out["x"], out["relres"], out["rnd"], out["iters"]


def _resident_refine_fn(tol_, inner_tol, inner_floor, max_rounds,
                        maxit_inner):
    """The jitted refinement program; operators/preconditioner are pytree
    ARGUMENTS (not closure constants), so XLA treats their arrays as
    parameters and the compiled program is reusable across hierarchies of
    the same structure."""
    import jax

    @jax.jit
    def run(op64, op32, M, b64):
        return _refine_body(op64, op32, M, b64, tol_, inner_tol,
                            inner_floor, max_rounds, maxit_inner)

    return run


def _expand_hierarchy(hier):
    """Materialize compressed (scalar x bitmask) operator/transfer leaves
    ONCE at program start: traced inside the Krylov while_loop their
    bit-unpacking would re-run every iteration (XLA does not reliably
    hoist it out of while bodies).  Runs inside jit; pack/upload savings
    are untouched."""
    import dataclasses as _dc

    from ..ops.operators import expand_compressed
    from ..precond.amg.transfer import expand_compressed_transfer as _ect
    levels = tuple(
        _dc.replace(
            l, A=expand_compressed(l.A),
            Asm=(expand_compressed(l.Asm) if l.Asm is not None else None),
            P=(_ect(l.P) if l.P is not None else None),
            R=(_ect(l.R) if l.R is not None else None))
        for l in hier.levels)
    f64 = (expand_compressed(hier.fine64)
           if hier.fine64 is not None else None)
    return _dc.replace(hier, levels=levels, fine64=f64)


def make_resident_refiner_packed(packed, *, tol: float = 1e-6,
                                 max_rounds: int = 4,
                                 inner_tol: float = 1e-5,
                                 inner_floor: float = 5e-6,
                                 maxit_inner: int = 40, M_maxit: int = 1,
                                 cast_b: bool = False):
    """Resident refiner over a :class:`~..ops.packing.PackedHierarchy`:
    the hierarchy is rebuilt from its flat buffers INSIDE the jitted
    program, so freezing it never costs an extra XLA program or per-leaf
    transfer (ops/packing.py).  The packed hierarchy must carry its f64
    fine operator (setup_structured(..., keep_f64_fine=True, pack=True)).

    ``cast_b=True``: the program accepts b in ANY dtype and promotes to
    f64 on-device.  Shipping b as f32 halves the h2d bytes; the device
    then refines against the f32-rounded b (relative perturbation
    ~6e-8), so the TRUE-b residual floors near 1e-7 — only valid for
    tol >= ~1e-6, and callers must verify against the exact b on host
    (bench.py does, untimed)."""
    import jax
    from ..precond import AMGPrecond

    if packed.p64 is None:
        raise ValueError("packed hierarchy has no f64 fine operator")
    tol_, it_, if_ = float(tol), float(inner_tol), float(inner_floor)
    mr_, mi_ = int(max_rounds), int(maxit_inner)

    @jax.jit
    def runp(bufs32, bufs64, b64):
        if cast_b:
            import jax.numpy as _jnp
            b64 = b64.astype(_jnp.float64)
        hier = _expand_hierarchy(packed.unpack(bufs32, bufs64))
        M = AMGPrecond(hier, maxit=M_maxit)
        return _refine_body(hier.fine64, hier.levels[0].A, M, b64,
                            tol_, it_, if_, mr_, mi_)

    b32, b64s = packed.p32.bufs, packed.p64.bufs

    def run(b64):
        return runp(b32, b64s, b64)

    def _compile(b_spec):
        ex = runp.lower(b32, b64s, b_spec).compile()
        return lambda b64: ex(b32, b64s, b64)

    run.compile = _compile
    return run


def solve_refined_resident(hier, b, M=None, *, tol: float = 1e-6,
                           max_rounds: int = 4, inner_tol: float = 1e-5,
                           inner_floor: float = 5e-6,
                           maxit_inner: int = 40) -> RefinedResult:
    """Device-resident refinement driven by an AMG hierarchy that carries
    its f64 fine operator (``setup_structured(..., keep_f64_fine=True)``).
    Falls back is the caller's job: ``hier.fine64 is None`` raises."""
    if hier.fine64 is None:
        raise ValueError("hierarchy has no f64 fine operator "
                         "(setup_structured(..., keep_f64_fine=True))")
    if M is None:
        from ..precond import AMGPrecond
        M = AMGPrecond(hier)
    run = make_resident_refiner(hier.fine64, hier.levels[0].A, M, tol=tol,
                                max_rounds=max_rounds, inner_tol=inner_tol,
                                inner_floor=inner_floor,
                                maxit_inner=maxit_inner)
    x, relres, rnd, iters = run(jnp.asarray(np.asarray(b), jnp.float64))
    relres_f = float(relres)
    return RefinedResult(x=np.asarray(x), rounds=int(rnd),
                         inner_iters=int(iters), relres=relres_f,
                         converged=relres_f < tol)
