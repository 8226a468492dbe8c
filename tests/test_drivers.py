"""Level-5 driver tests: the canonical user API over the reference corpus."""
import jax.numpy as jnp
import numpy as np
import pytest

from faspsolver_tpu.constants import AMGType, SolverType
from faspsolver_tpu.io import read_bsr, read_csrvec, read_vec, read_vecind
from faspsolver_tpu.solvers import (itsolver, krylov, krylov_amg, krylov_diag,
                                    solve_amg, solve_famg)
from faspsolver_tpu.utils.params import AMGParam, ITSParam


@pytest.fixture(scope="module")
def fd(refdata):
    A, b = read_csrvec(f"{refdata}/csrmat_FD.dat", f"{refdata}/rhs_FD.dat")
    sol = read_vecind(f"{refdata}/sol_FD.dat")
    return A, b, sol


def test_krylov_driver(fd):
    A, b, sol = fd
    res = krylov(A, b, its=ITSParam(tol=1e-10, maxit=200))
    assert bool(res.converged)
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_krylov_diag_driver(fd):
    A, b, sol = fd
    res = krylov_diag(A, b, its=ITSParam(tol=1e-10, maxit=200))
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_krylov_amg_driver(refdata):
    A, b = read_csrvec(f"{refdata}/csrmat_FE.dat", f"{refdata}/rhs_FE.dat")
    sol = read_vecind(f"{refdata}/sol_FE.dat")
    res, hier = krylov_amg(A, b, its=ITSParam(tol=1e-10, maxit=100))
    assert bool(res.converged)
    assert int(res.iters) <= 12
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_solve_amg_driver(fd):
    A, b, sol = fd
    res = solve_amg(A, b, amg=AMGParam(tol=1e-10, maxit=30))
    assert bool(res.converged)
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_bsr_krylov_amg_spe01(refdata):
    """SPE01 reservoir path (reference: testbsr.ex, ini/bsr.dat:
    vFGMRES + AMG to tight tolerance)."""
    A = read_bsr(f"{refdata}/bsrmat_SPE01.dat")
    b = read_vec(f"{refdata}/rhs_SPE01.dat")
    its = ITSParam(itsolver_type=int(SolverType.VFGMRES), tol=1e-8,
                   maxit=200, restart=30)
    res, hier = krylov_amg(A, b, its=its, amg=AMGParam())
    assert bool(res.converged)
    x = np.asarray(res.x)
    r = b - A.matvec(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-7


def test_safety_net_driver(fd):
    A, b, sol = fd
    its = ITSParam(itsolver_type=int(SolverType.SCG), tol=1e-10, maxit=200)
    res = itsolver(A, b, its=its)
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


# ---------------------------------------------------------------------------
# Near-kernel machinery (reference: fasp.h:849-852, PreMGCycle.c:369-391,
# SolBSR.c:476/:634)
# ---------------------------------------------------------------------------

def _component_basis(A):
    nb = A.nb
    B = np.zeros((A.nrow, nb))
    for t in range(nb):
        B[t::nb, t] = 1.0
    return B


def test_nk_basis_restricted_down_hierarchy(refdata):
    """setup_ua_bsr(nk=...) must attach NearKernel data on every level,
    with B_{l+1} = R_l B_l (checked against the device restriction op)."""
    from faspsolver_tpu.io import read_bsr
    from faspsolver_tpu.precond.amg.setup_bsr import setup_ua_bsr
    from faspsolver_tpu.utils.params import AMGParam
    A = read_bsr(f"{refdata}/bsrmat_SPE01.dat")
    B = _component_basis(A)
    h = setup_ua_bsr(A, AMGParam(aggregation_type=2, coarse_dof=30), nk=B)
    assert all(lvl.nk is not None for lvl in h.levels)
    assert h.levels[0].nk.B.shape == (A.nrow, A.nb)
    assert h.levels[0].nk.Ainv.shape == (A.nb, A.nb)
    for l in range(h.num_levels - 1):
        Bl = h.levels[l].nk.B
        Bn = h.levels[l + 1].nk.B
        for c in range(Bl.shape[1]):
            rb = np.asarray(h.levels[l].R(Bl[:, c]))
            assert np.max(np.abs(rb - np.asarray(Bn[:, c]))) < 1e-10


def test_nk_amg_driver_solves_spe01(refdata):
    from faspsolver_tpu.io import read_bsr, read_vec
    from faspsolver_tpu.solvers import drivers
    from faspsolver_tpu.utils.params import AMGParam, ITSParam
    A = read_bsr(f"{refdata}/bsrmat_SPE01.dat")
    b = np.asarray(read_vec(f"{refdata}/rhs_SPE01.dat"))
    res, h = drivers.krylov_nk_amg(
        A, b, _component_basis(A),
        its=ITSParam(itsolver_type=7, tol=1e-8, maxit=300, restart=30),
        amg=AMGParam(AMG_type=3, aggregation_type=2, coarse_dof=30))
    assert bool(res.converged)
    assert h.levels[0].nk is not None


def test_nk_cycle_correction_projects_kernel():
    """On a singular-free SPD system, the near-kernel correction must make
    one V-cycle exact on the basis directions: if r is in span(A B), the
    corrected error along B vanishes."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from faspsolver_tpu.formats import BSRMatrix
    from faspsolver_tpu.precond.amg.setup_bsr import setup_ua_bsr
    from faspsolver_tpu.precond.amg.cycles import mgcycle
    from faspsolver_tpu.testgen import poisson_2d
    from faspsolver_tpu.utils.params import AMGParam
    A1 = poisson_2d(16)                       # 256 dof
    Absr = BSRMatrix.from_csr(A1, nb=2)       # expand to nb=2 blocks
    m = Absr.to_scipy().tocsr()
    n = m.shape[0]
    B = np.zeros((n, 2))
    B[0::2, 0] = 1.0
    B[1::2, 1] = 1.0
    h = setup_ua_bsr(Absr, AMGParam(coarse_dof=16, aggregation_type=2),
                     nk=B)
    rhs = m @ B[:, 0]                         # residual exactly A*B e_0
    x = np.asarray(mgcycle(h, jnp.asarray(rhs)))
    # the near-kernel solve makes the B-component of the error exact
    gram = B.T @ (m @ B)
    coef = np.linalg.solve(gram, B.T @ (rhs - m @ x))
    assert np.abs(coef).max() < 1e-8
