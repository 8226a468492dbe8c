"""ILU, Schwarz, and GMG tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from faspsolver_tpu.io import read_csrvec, read_mtx
from faspsolver_tpu.krylov import pcg, gmres
from faspsolver_tpu.ops import device_operator
from faspsolver_tpu.precond import (poisson_gmg_2d, poisson_gmg_3d,
                                    setup_ilu, setup_schwarz,
                                    TriangularSolver)
from faspsolver_tpu.precond.ilu import iluk_factor
from faspsolver_tpu.testgen import poisson_2d, poisson_2d_manufactured
from faspsolver_tpu.utils.params import ILUParam, SWZParam
from faspsolver_tpu.constants import ILUType, SchwarzType

RNG = np.random.default_rng(5)


def test_triangular_solver_exact():
    n = 50
    L = sp.tril(sp.random(n, n, 0.2, random_state=1) + 2 * sp.eye(n)).tocsr()
    ts = TriangularSolver.from_sparse(L, lower=True)
    b = RNG.standard_normal(n)
    x = np.asarray(ts(jnp.asarray(b)))
    np.testing.assert_allclose(L @ x, b, atol=1e-10)
    U = L.T.tocsr()
    ts2 = TriangularSolver.from_sparse(U, lower=False)
    x2 = np.asarray(ts2(jnp.asarray(b)))
    np.testing.assert_allclose(U @ x2, b, atol=1e-10)


def test_ilu0_exact_on_tridiag():
    """ILU(0) of a tridiagonal matrix is the exact LU."""
    n = 40
    A = poisson_2d(n, 1)   # 1D chain: tridiagonal
    L, U = iluk_factor(A, 0)
    err = np.abs((L @ U - A.to_scipy()).toarray()).max()
    assert err < 1e-8 * np.abs(A.data).max()


def test_ilu_pcg(refdata):
    A, b = read_csrvec(f"{refdata}/csrmat_FE.dat", f"{refdata}/rhs_FE.dat")
    M = setup_ilu(A, ILUParam(ILU_type=int(ILUType.ILUK), ILU_lfil=1))
    op = device_operator(A, prefer="ell")
    res = pcg(op, jnp.asarray(b), M=M, tol=1e-10, maxit=200)
    assert bool(res.converged)
    assert int(res.iters) < 80
    x = np.asarray(res.x)
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) < 1e-9


def test_ilut_gmres_nonsymmetric(refdata):
    A = read_mtx(f"{refdata}/orsreg_1.mtx")
    b = A.matvec(RNG.standard_normal(A.nrow))
    M = setup_ilu(A, ILUParam(ILU_type=int(ILUType.ILUT), ILU_droptol=1e-3))
    op = device_operator(A, prefer="ell")
    res = gmres(op, jnp.asarray(b), M=M, tol=1e-9, maxit=500, restart=30)
    assert bool(res.converged)
    x = np.asarray(res.x)
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) < 1e-8


def test_schwarz_symmetric_pcg():
    A, b, u = poisson_2d_manufactured(20)
    M = setup_schwarz(A, SWZParam(SWZ_maxlvl=2,
                                  SWZ_type=int(SchwarzType.SYMMETRIC)))
    op = device_operator(A, prefer="ell")
    res = pcg(op, jnp.asarray(b), M=M, tol=1e-10, maxit=200)
    assert bool(res.converged)
    assert int(res.iters) < 60
    assert np.max(np.abs(np.asarray(res.x) - u)) < 1e-7


def test_schwarz_forward_gmres():
    # forward multiplicative Schwarz is nonsymmetric: pair it with GMRES
    A, b, u = poisson_2d_manufactured(20)
    M = setup_schwarz(A, SWZParam(SWZ_maxlvl=2,
                                  SWZ_type=int(SchwarzType.FORWARD)))
    op = device_operator(A, prefer="ell")
    res = gmres(op, jnp.asarray(b), M=M, tol=1e-10, maxit=200, restart=30)
    assert bool(res.converged)
    assert int(res.iters) < 60
    assert np.max(np.abs(np.asarray(res.x) - u)) < 1e-7


def test_gmg_2d():
    n = 64
    xs = np.arange(n + 1) / n
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u_exact = np.sin(np.pi * X) * np.sin(np.pi * Y)
    f = 2 * np.pi ** 2 * u_exact
    res = poisson_gmg_2d(jnp.asarray(f), n, tol=1e-8, maxit=50)
    assert bool(res.converged)
    assert int(res.iters) <= 12
    # discretization error ~ h^2
    assert np.max(np.abs(np.asarray(res.x) - u_exact)) < 5e-4


def test_gmg_2d_fmg():
    n = 64
    xs = np.arange(n + 1) / n
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    f = 2 * np.pi ** 2 * np.sin(np.pi * X) * np.sin(np.pi * Y)
    res = poisson_gmg_2d(jnp.asarray(f), n, tol=1e-8, maxit=50,
                         full_first=True)
    assert bool(res.converged)


def test_gmg_3d():
    n = 16
    xs = np.arange(n + 1) / n
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    u_exact = (np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z))
    f = 3 * np.pi ** 2 * u_exact
    res = poisson_gmg_3d(jnp.asarray(f), n, tol=1e-8, maxit=60)
    assert bool(res.converged)
    assert np.max(np.abs(np.asarray(res.x) - u_exact)) < 5e-3


# ---------------------------------------------------------------------------
# Native ILUtp + block ILU(0) + deep-level scan solver
# ---------------------------------------------------------------------------

def test_native_ilutp_pivots_and_factors_exactly():
    """With full fill and no dropping, native ILUtp must reproduce
    L U = A P exactly even when pivoting fires (zero diagonal)."""
    import scipy.sparse as sp
    from faspsolver_tpu import native
    from faspsolver_tpu.formats import CSRMatrix
    if not native.available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(3)
    n = 40
    m = sp.random(n, n, density=0.3, random_state=7, format="csr")
    m = m + sp.diags(np.r_[0.0, 2.0 + rng.random(n - 1)])  # force a pivot
    A = CSRMatrix.from_scipy(m.tocsr())
    L, U, perm = native.ilutp(A, lfil=1000, droptol=0.0, permtol=1.0)
    assert (perm != np.arange(n)).any()          # pivoting actually fired
    P = sp.csr_matrix((np.ones(n), (perm, np.arange(n))), shape=(n, n))
    assert abs((L @ U) - (m @ P)).max() < 1e-10


def test_ilutp_precond_applies_inverse():
    """setup_ilu(ILUtp) with pivoting enabled approximates A^{-1} well on a
    zero-diagonal nonsymmetric matrix that unpivoted ILU cannot handle."""
    import scipy.sparse as sp
    import jax.numpy as jnp
    from faspsolver_tpu.formats import CSRMatrix
    from faspsolver_tpu.precond.ilu import setup_ilu
    from faspsolver_tpu.utils.params import ILUParam
    rng = np.random.default_rng(5)
    n = 80
    m = sp.random(n, n, density=0.12, random_state=2, format="csr")
    m = m + sp.diags(np.r_[0.0, 2.0 + rng.random(n - 1)])
    A = CSRMatrix.from_scipy(m.tocsr())
    M = setup_ilu(A, ILUParam(ILU_type=3, ILU_droptol=1e-10, ILU_lfil=n,
                              ILU_permtol=0.5))
    r = rng.random(n)
    z = np.asarray(M(jnp.asarray(r)))
    assert np.linalg.norm(m @ z - r) / np.linalg.norm(r) < 1e-6


def test_block_ilu0_spe01(refdata):
    """True block ILU(0) (no CSR expansion) preconditions SPE01 to
    convergence through the BSR driver."""
    from faspsolver_tpu.io import read_bsr, read_vec
    from faspsolver_tpu.precond.ilu import setup_bsr_ilu0
    from faspsolver_tpu.solvers import drivers
    from faspsolver_tpu.utils.params import ILUParam, ITSParam
    A = read_bsr(f"{refdata}/bsrmat_SPE01.dat")
    b = read_vec(f"{refdata}/rhs_SPE01.dat")
    M = setup_bsr_ilu0(A)
    assert M.nb == 3
    res = drivers.krylov_ilu(A, np.asarray(b),
                             its=ITSParam(itsolver_type=7, tol=1e-8,
                                          maxit=300, restart=30),
                             ilu=ILUParam(ILU_lfil=0))
    assert bool(res.converged)
    assert int(res.iters) <= 60


def test_block_ilu0_native_python_parity(refdata):
    from faspsolver_tpu import native
    from faspsolver_tpu.io import read_bsr
    from faspsolver_tpu.precond.ilu import _bsr_ilu0_py
    if not native.available():
        pytest.skip("no native toolchain")
    A = read_bsr(f"{refdata}/bsrmat_SPE01.dat")
    n, nb = A.nrow_block, A.nb
    order = np.lexsort((A.indices,
                        np.repeat(np.arange(n), np.diff(A.indptr))))
    idx, dat = A.indices[order], A.data[order]
    fn, dn = native.bsr_ilu0(A.indptr, idx, dat, n, nb)
    fp, dp = _bsr_ilu0_py(n, nb, A.indptr, idx, dat)
    assert np.abs(fn - fp).max() < 1e-9
    assert np.abs(dn - dp).max() < 1e-9


def test_triangular_solver_deep_levels_scan():
    """A factor with hundreds of dependency levels must build a bounded
    number of traced segments (lax.scan tail) and still solve exactly."""
    import scipy.sparse.linalg as spl
    import jax
    import jax.numpy as jnp
    from faspsolver_tpu import native
    from faspsolver_tpu.precond.ilu import (TriangularSolver, _TriScan,
                                            ilut_factor)
    from faspsolver_tpu.testgen import poisson_2d
    A = poisson_2d(60)                            # 3600 dof
    if native.available():
        L, _ = native.ilut(A, 20, 1e-4)
    else:
        L, _ = ilut_factor(A, 1e-4)
    ts = TriangularSolver.from_sparse(L, lower=True)
    assert len(ts.segments) <= 48                 # bounded trace size
    assert any(isinstance(s, _TriScan) for s in ts.segments) or \
        len(ts.segments) <= 48
    r = np.random.default_rng(0).random(A.nrow)
    y = np.asarray(jax.jit(lambda b: ts(b))(jnp.asarray(r)))
    yref = spl.spsolve_triangular(L.tocsr(), r, lower=True)
    assert np.abs(y - yref).max() < 1e-10
