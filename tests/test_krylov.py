"""Krylov solver correctness: convergence on the reference corpus with
iteration counts in the golden regime (BASELINE.md)."""
import jax.numpy as jnp
import numpy as np
import pytest

from faspsolver_tpu.io import read_csrvec, read_mtx
from faspsolver_tpu.krylov import (bicgstab, gcr, gmres, minres, pcg, vfgmres,
                                   vgmres, JacobiPrecond)
from faspsolver_tpu.ops import device_operator
from faspsolver_tpu.testgen import poisson_2d_manufactured

RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def fd_system(refdata):
    A, b = read_csrvec(f"{refdata}/csrmat_FD.dat", f"{refdata}/rhs_FD.dat")
    return A, device_operator(A, prefer="ell"), jnp.asarray(b)


@pytest.fixture(scope="module")
def poisson_sys():
    A, b, u = poisson_2d_manufactured(24)
    return A, device_operator(A, prefer="ell"), jnp.asarray(b), u


def _check(A, res, b, tol=1e-6):
    x = np.asarray(res.x)
    r = np.asarray(b) - A.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 10 * tol
    assert bool(res.converged)


def test_pcg_fd(fd_system):
    A, op, b = fd_system
    res = pcg(op, b, tol=1e-8, maxit=200)
    _check(A, res, b, 1e-8)


def test_pcg_jacobi(poisson_sys):
    A, op, b, u = poisson_sys
    res = pcg(op, b, M=JacobiPrecond.from_csr(A), tol=1e-10, maxit=2000)
    _check(A, res, b, 1e-10)
    assert np.max(np.abs(np.asarray(res.x) - u)) < 1e-6


def test_pcg_stop_types(poisson_sys):
    A, op, b, _ = poisson_sys
    for st in (1, 2, 3):
        res = pcg(op, b, tol=1e-9, maxit=2000, stop_type=st)
        _check(A, res, b, 1e-6)


def test_pcg_golden_iteration_count(refdata):
    """Unpreconditioned CG on the FE Poisson system: reference golden count
    is 244 iterations to relres 1e-12 (BASELINE.md / test/out/reg.out)."""
    A, b = read_csrvec(f"{refdata}/csrmat_FE.dat", f"{refdata}/rhs_FE.dat")
    op = device_operator(A, prefer="ell")
    res = pcg(op, jnp.asarray(b), tol=1e-12, maxit=1000)
    assert bool(res.converged)
    assert abs(int(res.iters) - 244) <= 5   # same convergence regime


def test_bicgstab(poisson_sys):
    A, op, b, _ = poisson_sys
    res = bicgstab(op, b, M=JacobiPrecond.from_csr(A), tol=1e-9, maxit=2000)
    _check(A, res, b, 1e-8)


def test_bicgstab_nonsymmetric(refdata):
    # manufactured random solution, the reference regression methodology
    # (regression_mm.c: b = A * rand)
    A = read_mtx(f"{refdata}/jpwh_991.mtx")
    op = device_operator(A, prefer="ell")
    b = jnp.asarray(A.matvec(RNG.standard_normal(A.nrow)))
    res = bicgstab(op, b, M=JacobiPrecond.from_csr(A), tol=1e-9, maxit=2000)
    _check(A, res, b, 1e-8)


def test_gmres(poisson_sys):
    A, op, b, _ = poisson_sys
    res = gmres(op, b, tol=1e-9, maxit=2000, restart=30)
    _check(A, res, b, 1e-8)


def test_gmres_nonsymmetric(refdata):
    A = read_mtx(f"{refdata}/sherman1.mtx")
    op = device_operator(A, prefer="ell")
    b = jnp.asarray(A.matvec(RNG.standard_normal(A.nrow)))
    res = gmres(op, b, M=JacobiPrecond.from_csr(A), tol=1e-9, maxit=2000,
                restart=30)
    _check(A, res, b, 1e-8)


def test_vgmres(refdata):
    A = read_mtx(f"{refdata}/sherman1.mtx")
    op = device_operator(A, prefer="ell")
    b = jnp.asarray(A.matvec(RNG.standard_normal(A.nrow)))
    res = vgmres(op, b, M=JacobiPrecond.from_csr(A), tol=1e-9, maxit=2000,
                 restart=30)
    _check(A, res, b, 1e-8)


def test_vfgmres(poisson_sys):
    A, op, b, _ = poisson_sys
    res = vfgmres(op, b, M=JacobiPrecond.from_csr(A), tol=1e-9, maxit=2000,
                  restart=30)
    _check(A, res, b, 1e-8)


def test_minres(poisson_sys):
    A, op, b, _ = poisson_sys
    res = minres(op, b, M=JacobiPrecond.from_csr(A), tol=1e-9, maxit=2000)
    _check(A, res, b, 1e-8)


def test_gcr(poisson_sys):
    A, op, b, _ = poisson_sys
    res = gcr(op, b, M=JacobiPrecond.from_csr(A), tol=1e-9, maxit=2000,
              restart=30)
    _check(A, res, b, 1e-8)


def test_safe_mode_returns_best(poisson_sys):
    A, op, _, _ = poisson_sys
    b = jnp.asarray(RNG.standard_normal(A.nrow))       # rough rhs
    res = pcg(op, b, tol=1e-14, maxit=10, safe=True)   # will not converge
    assert not bool(res.converged)
    x = np.asarray(res.x)
    # best iterate is still a meaningful partial solve
    assert np.linalg.norm(np.asarray(b) - A.matvec(x)) < np.linalg.norm(b)


def test_zero_rhs(poisson_sys):
    A, op, b, _ = poisson_sys
    res = pcg(op, jnp.zeros_like(b), tol=1e-10, maxit=100)
    assert int(res.iters) == 0     # initial residual already below tol
    assert np.allclose(np.asarray(res.x), 0.0)


def test_solve_refined_mixed_precision():
    """f32 inner solves under the f64 refinement loop must reach f64-level
    residuals (the f32 performance mode, solvers/refine.py)."""
    import jax.numpy as jnp
    from faspsolver_tpu.krylov import pcg
    from faspsolver_tpu.precond import AMGPrecond
    from faspsolver_tpu.precond.amg import setup_structured
    from faspsolver_tpu.solvers import solve_refined
    from faspsolver_tpu.testgen import poisson_2d
    from faspsolver_tpu.utils.params import AMGParam

    A = poisson_2d(48)
    b = A.matvec(np.ones(A.nrow))
    hier = setup_structured(A, AMGParam(coarse_dof=60),
                            dtype=jnp.float32, smooth_p=True)
    M = AMGPrecond(hier)
    op = hier.levels[0].A
    res = solve_refined(A, b,
                        lambda r, tol: pcg(op, r, M=M, tol=tol, maxit=40),
                        tol=1e-10, dtype=jnp.float32)
    assert res.converged
    assert res.relres < 1e-10            # far below any single f32 solve
    assert res.rounds >= 2
    r = b - A.matvec(res.x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def test_solve_refined_stall_guard():
    """A non-improving inner solve must stop refinement early (stall
    guard in solvers/refine.py) instead of burning max_rounds."""
    import types

    from faspsolver_tpu.solvers import solve_refined
    from faspsolver_tpu.testgen import poisson_2d

    A = poisson_2d(16)
    b = A.matvec(np.ones(A.nrow))
    calls = []

    def dead_inner(r, tol):
        calls.append(1)
        return types.SimpleNamespace(x=jnp.zeros_like(r), iters=7)

    res = solve_refined(A, b, dead_inner, tol=1e-12, max_rounds=50)
    assert not res.converged
    assert len(calls) <= 2               # stalled after the first round
    assert res.inner_iters == 7 * len(calls)


def test_benchmark_precision_escalation():
    """nos7's ~4e9 conditioning exhausts the f32-inner refinement budget;
    the benchmark harness must escalate to a device f64 inner solve and
    converge (benchmark/harness.py) — the reference is REAL=double
    throughout (fasp.h:75), so a FAILED row here would be a precision
    artifact, not a solver gap."""
    from faspsolver_tpu.benchmark.harness import _refined_factory
    from faspsolver_tpu.io import read_mtx

    A = read_mtx("/root/reference/data/nos7.mtx")
    b = A.matvec(np.ones(A.nrow))
    res = _refined_factory("ilu")(A, b)
    assert res.converged
    assert res.relres < 1e-8
    r = b - A.matvec(np.asarray(res.x, dtype=np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6
