"""Machine-normalized solver benchmark harness.

Reference: benchmark/main/benchmark.c — defines the library's own cost
unit lMVU ("local stencil SpMV unit": unpreconditioned-CG time per row per
iteration on a baseline 2D Poisson, ComputeLMVUFromBaseline,
benchmark.c:338-430), then scores each problem as

    Score = solve_time / n / lMVU            (benchmark.c:303)

so results compare across machines.  The reference sweeps up to 235
SuiteSparse problems (benchmark/input.dat); here the problem list is any
collection of MatrixMarket files (e.g. the shipped data/*.mtx corpus) or
generated systems.

Run:  python -m faspsolver_tpu.benchmark [--data DIR] [--solver amg|ilu|cg]
"""
from __future__ import annotations

import glob
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np


@dataclass
class BenchResult:
    name: str
    n: int
    nnz: int
    iters: int
    solve_s: float
    score: float          # solve_time / n / lMVU
    converged: bool


def _sync(x) -> None:
    import jax
    jax.block_until_ready(x)


def _print_platform() -> None:
    """Stamp the recording with the execution platform and precision so a
    committed transcript says where and how it ran."""
    import jax
    from ..ops.operators import default_dtype
    print(f"platform={jax.devices()[0].platform} "
          f"dtype={np.dtype(default_dtype()).name} "
          f"devices={len(jax.devices())}")


def compute_lmvu(n_base: int = 255, iters: int = 50) -> float:
    """lMVU: CG time per row per iteration on an n_base^2 2D Poisson
    (reference: ComputeLMVUFromBaseline, benchmark.c:338-430)."""
    import jax.numpy as jnp
    from ..krylov import pcg
    from ..ops import device_operator
    from ..testgen import poisson_2d

    A = poisson_2d(n_base)
    op = device_operator(A)
    b = jnp.asarray(A.matvec(np.ones(A.nrow)), dtype=op.dtype)
    res = pcg(op, b, tol=1e-300, maxit=iters)      # run exactly `iters`
    _sync(res.x)                                   # warm (compile)
    t0 = time.perf_counter()
    res = pcg(op, b, tol=1e-300, maxit=iters)
    _sync(res.x)
    dt = time.perf_counter() - t0
    return dt / A.nrow / max(int(res.iters), 1)


def score_problem(name: str, A, b, solver: Callable, lmvu: float
                  ) -> BenchResult:
    import jax.numpy as jnp
    res = solver(A, b)
    _sync(res.x)                                   # warm (compile)
    t0 = time.perf_counter()
    res = solver(A, b)
    _sync(res.x)
    dt = time.perf_counter() - t0
    return BenchResult(name=name, n=A.nrow, nnz=A.nnz,
                       iters=int(res.iters), solve_s=dt,
                       score=dt / A.nrow / lmvu,
                       converged=bool(res.converged))


def _solver_factory(kind: str):
    from ..constants import ILUType, SolverType
    from ..solvers import krylov, krylov_amg, krylov_ilu
    from ..utils.params import ILUParam, ITSParam
    from ..ops.operators import default_dtype

    if np.dtype(default_dtype()) == np.float32:
        # f32 mode (x64 off): the target tol 1e-8 is below the f32
        # residual floor, so f32 runs use the framework's mixed-precision
        # mode — f32 AMG/ILU-preconditioned vGMRES inside f64
        # refinement.  Scores stay lMVU-normalized; `iters` reports total
        # inner iterations.
        return _refined_factory(kind)

    its = ITSParam(itsolver_type=int(SolverType.VGMRES), tol=1e-8,
                   maxit=2000, restart=60)
    if kind == "amg":
        return lambda A, b: krylov_amg(A, b, its=its)[0]
    if kind == "ilu":
        # pivoted ILU: the robust default for an arbitrary SuiteSparse mix
        ilu = ILUParam(ILU_type=int(ILUType.ILUTP), ILU_droptol=1e-4)
        return lambda A, b: krylov_ilu(A, b, its=its, ilu=ilu)
    cg_its = ITSParam(tol=1e-8, maxit=5000)
    return lambda A, b: krylov(A, b, its=cg_its)


def _refined_factory(kind: str):
    """f32 inner Krylov + f64 refinement to 1e-8 (solvers.solve_refined)."""
    import dataclasses
    import jax.numpy as jnp

    from ..constants import ILUType
    from ..krylov import pcg, vgmres
    from ..ops import device_operator
    from ..precond import AMGPrecond, setup_ilu
    from ..precond.amg import setup_rs
    from ..solvers import solve_refined
    from ..utils.params import AMGParam, ILUParam

    @dataclasses.dataclass
    class _Res:
        x: object
        iters: int
        relres: float
        converged: bool

    def make_inner(A, dt, maxit_kry=None):
        op = device_operator(A, dtype=dt)
        if kind == "amg":
            M = AMGPrecond(setup_rs(A, AMGParam(), dtype=dt))
        elif kind == "ilu":
            M = setup_ilu(A, ILUParam(ILU_type=int(ILUType.ILUTP),
                                      ILU_droptol=1e-4), dtype=dt)
        else:
            M = None
        # inner budgets bounded so a floor-stalled solve cannot become a
        # minutes-long single device program (watchdog territory);
        # refinement rounds + rescues supply the depth.  The f64
        # escalation passes a deeper budget explicitly (no f32 floor to
        # stall on, and it only engages on small hard problems).
        mk = maxit_kry if maxit_kry is not None else 400

        def inner(r, tl):
            if kind == "cg":
                return pcg(op, r, M=M, tol=tl, maxit=max(mk, 500),
                           max_stag=2, max_restart=2)
            return vgmres(op, r, M=M, tol=tl, maxit=mk, restart=60)
        return inner

    def run(A, b):
        import dataclasses as _dc
        import jax

        res = solve_refined(A, b, make_inner(A, jnp.float32), tol=1e-8,
                            max_rounds=8, dtype=jnp.float32)
        if res.converged:
            return _Res(x=res.x, iters=res.inner_iters, relres=res.relres,
                        converged=True)

        # rescue: symmetric diagonal scaling INSIDE the inner solve
        # (fasp_dcsr_symdiagscale analog) — the outer refinement stays on
        # the ORIGINAL system, so convergence is still the true unscaled
        # residual; only the Krylov correction solves (S A S) y = S r.
        # This squeezes the dynamic range the reduced-precision inner
        # sees (closed watt__1-class rows in round 3)
        import scipy.sparse as _sp

        from ..formats import CSRMatrix as _CSR
        d = np.abs(np.asarray(A.diagonal(), dtype=np.float64))
        s = 1.0 / np.sqrt(np.where(d > 0, d, 1.0))
        scaled = not np.allclose(s, 1.0)
        As = None
        if scaled:
            S = _sp.diags(s)
            As = _CSR.from_scipy((S @ A.to_scipy() @ S).tocsr())

        def scaled_inner(base_inner, dt):
            s_dev = jnp.asarray(s, dtype=dt)

            def inner(r, tl):
                rs = r * s_dev
                out = base_inner(rs, tl)
                return _dc.replace(out, x=out.x * s_dev)
            return inner

        total = res.inner_iters
        if scaled:
            res_s = solve_refined(
                A, b, scaled_inner(make_inner(As, jnp.float32),
                                   jnp.float32),
                tol=1e-8, max_rounds=8, dtype=jnp.float32)
            total += res_s.inner_iters
            if res_s.converged:
                if not getattr(run, "_scale_announced", False):
                    print(f"  [f32 refinement stalled at "
                          f"relres={res.relres:.2e}; diagscaled-inner "
                          f"f32 retry converged]")
                    run._scale_announced = True
                return _Res(x=res_s.x, iters=total, relres=res_s.relres,
                            converged=True)

        # precision escalation: conditioning beyond the f32-inner budget
        # (nos7-class, cond ~4e9: refinement gains <1 digit a round and
        # stalls).  Rerun with a device f64 inner solve, still
        # diagonally scaled inside.  The escalated run is timed into the
        # score: that is the cost of this problem on this platform, not
        # hidden behind a FAILED row.  The reference is REAL=double
        # throughout (fasp.h:75).
        if not getattr(run, "_esc_announced", False):
            # announce once per problem: the warm and timed runs both
            # escalate, and duplicate banners read as two failures in
            # the recordings
            print(f"  [f32 refinement unconverged at "
                  f"relres={res.relres:.2e} ({res.rounds} rounds, "
                  f"{res.inner_iters} inner iters) -> f64 escalation]")
            run._esc_announced = True
        x64_prev = jax.config.jax_enable_x64
        # CAUTION: the global x64 flip below changes dtype promotion for
        # ANY tracing that happens inside this window; the inner
        # make_inner(..., jnp.float64) closures are traced here by
        # design, and nothing else may trace concurrently
        jax.config.update("jax_enable_x64", True)
        try:
            mk64 = 1600 if A.nrow <= 16384 else 400
            base64 = make_inner(As if scaled else A, jnp.float64,
                                maxit_kry=mk64)
            inner64 = scaled_inner(base64, jnp.float64) if scaled \
                else base64
            res64 = solve_refined(A, b, inner64, tol=1e-8, max_rounds=3,
                                  inner_tol=1e-8, inner_floor=1e-9,
                                  dtype=jnp.float64)
        finally:
            jax.config.update("jax_enable_x64", x64_prev)
        return _Res(x=res64.x, iters=total + res64.inner_iters,
                    relres=res64.relres, converged=res64.converged)

    return run


def generated_problems(sizes_2d=(255, 511, 1023), sizes_3d=(31, 47, 101)):
    """FDM Poisson systems with manufactured b (analog of the reference's
    generated test systems, test/src/FdmPoisson.c + testfdm3d.cpp); the
    1023^2 (1.05M dof) and 101^3 (1.03M dof) rows are the >=1M-dof scaling
    points BASELINE.md directs the harness to cover."""
    from ..testgen import poisson_2d, poisson_3d
    out = []
    for n in sizes_2d:
        A = poisson_2d(n)
        out.append((f"fdm2d-{n}x{n}", A, A.matvec(np.ones(A.nrow))))
    for n in sizes_3d:
        A = poisson_3d(n)
        out.append((f"fdm3d-{n}^3", A, A.matvec(np.ones(A.nrow))))
    return out


def run_generated(solver_kind: str = "amg") -> List[BenchResult]:
    """Score the generated FDM corpus (lMVU-normalized like the reference
    scores SuiteSparse problems)."""
    _print_platform()
    lmvu = compute_lmvu()
    print(f"lMVU = {lmvu:.3e} s/row/iter")
    solver = _solver_factory(solver_kind)
    results = []
    for name, A, b in generated_problems():
        r = score_problem(name, A, b, solver, lmvu)
        results.append(r)
        print(f"{r.name:16s} n={r.n:8d} nnz={r.nnz:9d} iters={r.iters:5d} "
              f"t={r.solve_s:8.3f}s score={r.score:10.1f} "
              f"{'ok' if r.converged else 'FAILED'}")
    return results


def run_benchmark(datadir: str, solver_kind: str = "ilu",
                  min_size: int = 0, max_size: int = 200_000,
                  problems: Optional[List[str]] = None) -> List[BenchResult]:
    from ..io import read_mtx
    from ..utils import messages

    _print_platform()
    lmvu = compute_lmvu()
    print(f"lMVU = {lmvu:.3e} s/row/iter")
    solver = _solver_factory(solver_kind)
    results = []
    files = problems or sorted(glob.glob(os.path.join(datadir, "*.mtx")))
    for path in files:
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            A = read_mtx(path)
        except Exception as e:  # noqa: BLE001
            messages.warn(f"{name}: unreadable ({e})")
            continue
        if not (min_size <= A.nrow <= max_size) or A.nrow != A.ncol:
            continue
        b = A.matvec(np.ones(A.nrow))
        try:
            r = score_problem(name, A, b, solver, lmvu)
        except Exception as e:  # noqa: BLE001
            messages.warn(f"{name}: solver failed ({e})")
            continue
        results.append(r)
        print(f"{r.name:16s} n={r.n:8d} nnz={r.nnz:9d} iters={r.iters:5d} "
              f"t={r.solve_s:8.3f}s score={r.score:10.1f} "
              f"{'ok' if r.converged else 'FAILED'}")
    if results:
        ok = [r for r in results if r.converged]
        print("-" * 72)
        print(f"{len(ok)}/{len(results)} solved; "
              f"mean score {np.mean([r.score for r in ok]):.1f}"
              if ok else "no problems solved")
    return results


def corpus_problems(scale: int = 255):
    """Generated benchmark corpus with the DIVERSITY of the reference's
    SuiteSparse sweep (benchmark/input.dat, 235 problems) — no network
    here, so the problem classes are matched instead of the files:
    anisotropy (1e-3..1e3), jump coefficients (1e2..1e6),
    convection-diffusion (nonsymmetric, 3 strengths), stretched grids,
    3-D anisotropy, plus the isotropic Poisson baselines.  >= 20 scored
    problems, >= 3 nonsymmetric."""
    from ..testgen import (anisotropic_2d, anisotropic_3d, convdiff_2d,
                           jump_2d, poisson_2d, poisson_3d, stretched_2d)
    n = scale
    n3 = 31 if scale <= 255 else 47
    probs = [
        ("poisson2d", poisson_2d(n)),
        ("poisson3d", poisson_3d(n3)),
        ("aniso-x-1e1", anisotropic_2d(n, 1e-1)),
        ("aniso-x-1e2", anisotropic_2d(n, 1e-2)),
        ("aniso-x-1e3", anisotropic_2d(n, 1e-3)),
        ("aniso-y-1e1", anisotropic_2d(n, 1e1)),
        ("aniso-y-1e2", anisotropic_2d(n, 1e2)),
        ("aniso-y-1e3", anisotropic_2d(n, 1e3)),
        ("aniso3d-weak", anisotropic_3d(n3, 1e-2, 1e-2)),
        ("aniso3d-mixed", anisotropic_3d(n3, 1e-2, 1e2)),
        ("jump-1e2", jump_2d(n, 1e2)),
        ("jump-1e4", jump_2d(n, 1e4)),
        ("jump-1e6", jump_2d(n, 1e6)),
        ("jump-inv-1e4", jump_2d(n, 1e-4)),
        ("convdiff-mild", convdiff_2d(n, 10.0, 5.0)),
        ("convdiff-strong", convdiff_2d(n, 100.0, 50.0)),
        ("convdiff-grid", convdiff_2d(n, 2.0 * (n + 1), n + 1.0)),
        ("stretched-1e1", stretched_2d(n, 1e1)),
        ("stretched-1e2", stretched_2d(n, 1e2)),
        ("stretched-1e3", stretched_2d(n, 1e3)),
    ]
    return [(name, A, A.matvec(np.ones(A.nrow))) for name, A in probs]


def run_corpus(solver_kind: str = "amg", scale: int = 255
               ) -> List[BenchResult]:
    """Score the generated diversity corpus (lMVU-normalized, analog of
    benchmark/main/benchmark.c:303 over input.dat)."""
    _print_platform()
    lmvu = compute_lmvu()
    print(f"lMVU = {lmvu:.3e} s/row/iter")
    solver = _solver_factory(solver_kind)
    results = []
    for name, A, b in corpus_problems(scale):
        try:
            r = score_problem(name, A, b, solver, lmvu)
        except Exception as e:  # noqa: BLE001
            from ..utils import messages
            messages.warn(f"{name}: solver failed ({e})")
            continue
        results.append(r)
        print(f"{r.name:16s} n={r.n:8d} nnz={r.nnz:9d} iters={r.iters:5d} "
              f"t={r.solve_s:8.3f}s score={r.score:10.1f} "
              f"{'ok' if r.converged else 'FAILED'}")
    ok = [r for r in results if r.converged]
    print(f"corpus: {len(ok)}/{len(results)} converged")
    return results
