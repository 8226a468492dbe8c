"""AMG correctness + golden convergence-regime parity (BASELINE.md)."""
import jax.numpy as jnp
import numpy as np
import pytest

from faspsolver_tpu.constants import (AggregationType, CycleType,
                                      InterpType, SmootherType)
from faspsolver_tpu.io import read_csrvec, read_vecind
from faspsolver_tpu.krylov import pcg
from faspsolver_tpu.ops import device_operator
from faspsolver_tpu.precond import AMGPrecond
from faspsolver_tpu.precond.amg import (amg_solve, famg_solve, setup_rs,
                                        setup_sa, setup_ua)
from faspsolver_tpu.testgen import poisson_2d_manufactured
from faspsolver_tpu.utils.params import AMGParam


@pytest.fixture(scope="module")
def fe(refdata):
    A, b = read_csrvec(f"{refdata}/csrmat_FE.dat", f"{refdata}/rhs_FE.dat")
    sol = read_vecind(f"{refdata}/sol_FE.dat")
    return A, jnp.asarray(b), sol


def test_rs_v_direct_golden(fe):
    A, b, sol = fe
    h = setup_rs(A, AMGParam(interpolation_type=int(InterpType.DIRECT),
                             smoother=int(SmootherType.GS)))
    res = amg_solve(h, b, tol=1e-10, maxit=30)
    assert bool(res.converged)
    assert int(res.iters) <= 12          # golden: 8 (multicolor GS shifts ~1)
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4  # acceptance rule


def test_rs_w_cycle_golden(fe):
    A, b, sol = fe
    h = setup_rs(A, AMGParam(cycle_type=int(CycleType.W),
                             smoother=int(SmootherType.GS)))
    res = amg_solve(h, b, tol=1e-10, maxit=20)
    assert bool(res.converged)
    assert int(res.iters) <= 6           # golden: 3
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_rs_amli_golden(fe):
    A, b, sol = fe
    h = setup_rs(A, AMGParam(cycle_type=int(CycleType.AMLI), amli_degree=3,
                             smoother=int(SmootherType.GS)))
    res = amg_solve(h, b, tol=1e-10, maxit=30)
    assert bool(res.converged)
    assert int(res.iters) <= 9           # golden: 6
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_rs_nlamli(fe):
    A, b, sol = fe
    h = setup_rs(A, AMGParam(cycle_type=int(CycleType.NL_AMLI),
                             smoother=int(SmootherType.GS)))
    res = amg_solve(h, b, tol=1e-10, maxit=30)
    assert bool(res.converged)
    assert int(res.iters) <= 9           # golden: 6
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_rs_sgs_golden(fe):
    A, b, sol = fe
    h = setup_rs(A, AMGParam(smoother=int(SmootherType.SGS)))
    res = amg_solve(h, b, tol=1e-10, maxit=40)
    assert bool(res.converged)
    assert int(res.iters) <= 18          # golden: 12
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_sa_golden(fe):
    A, b, sol = fe
    h = setup_sa(A, AMGParam(aggregation_type=int(AggregationType.VMB),
                             smoother=int(SmootherType.GS)))
    res = amg_solve(h, b, tol=1e-10, maxit=100)
    assert bool(res.converged)
    assert int(res.iters) <= 68          # golden: 45
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_ua_pairwise_golden(fe):
    A, b, sol = fe
    h = setup_ua(A, AMGParam(aggregation_type=int(AggregationType.PAIRWISE),
                             pair_number=2, smoother=int(SmootherType.GS)))
    res = amg_solve(h, b, tol=1e-10, maxit=250)
    assert bool(res.converged)
    assert int(res.iters) <= 170         # golden: 113
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_famg(fe):
    A, b, sol = fe
    h = setup_rs(A, AMGParam(smoother=int(SmootherType.GS)))
    res = famg_solve(h, b, tol=1e-10, maxit=30)
    assert bool(res.converged)
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_ua_amg_pcg(fe):
    A, b, sol = fe
    h = setup_ua(A, AMGParam(aggregation_type=int(AggregationType.VMB),
                             smoother=int(SmootherType.GS)))
    res = pcg(device_operator(A, prefer="ell"), b, M=AMGPrecond(h),
              tol=1e-12, maxit=200)
    assert bool(res.converged)
    assert int(res.iters) < 80
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_cheby_smoother():
    A, b, u = poisson_2d_manufactured(24)
    h = setup_rs(A, AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                             polynomial_degree=3))
    res = amg_solve(h, jnp.asarray(b), tol=1e-10, maxit=40)
    assert bool(res.converged)
    assert np.max(np.abs(np.asarray(res.x) - u)) < 1e-6


def test_hierarchy_complexity(fe):
    A, _, _ = fe
    h = setup_rs(A, AMGParam())
    gc, oc = h.complexity()
    assert 1.0 < gc < 2.5
    assert 1.0 < oc < 4.0


# ---------------------------------------------------------------------------
# Aggregation honesty + quality machinery (reference: PreAMGSetupUA.c,
# PreAMGAggregationUA.inl)
# ---------------------------------------------------------------------------

def test_aggregation_type_honored_above_2000(fe):
    """A VMB request on FE-3969 must actually run VMB (no silent
    size-threshold override): VMB neighborhood aggregates are larger than
    quality-bounded pairs, so the coarse grid is visibly coarser."""
    from faspsolver_tpu.precond.amg.aggregation import aggregate
    A, _, _ = fe
    p_vmb = AMGParam(aggregation_type=int(AggregationType.VMB))
    p_pair = AMGParam(aggregation_type=int(AggregationType.PAIRWISE))
    agg_v, nagg_v = aggregate(A, p_vmb, 0.08)
    agg_p, nagg_p = aggregate(A, p_pair, 0.08)
    assert nagg_v < nagg_p * 0.7        # distinct algorithms, distinct grids
    assert agg_v.min() >= 0 and agg_p.min() >= 0
    assert agg_v.max() + 1 == nagg_v and agg_p.max() + 1 == nagg_p


def test_pairwise_quality_bound_used():
    """Tightening quality_bound must refuse pairs.  Uses a 1-D Laplacian
    (bandwidth 3 <= 5, so the bandwidth override of
    aggregation_symmpair does not mask the configured bound); interior
    pairs have Notay measure mu = 2, so bound 8 accepts and 1.5 refuses."""
    from faspsolver_tpu.formats import CSRMatrix
    from faspsolver_tpu.precond.amg.aggregation import aggregate_pairwise
    import scipy.sparse as sp
    n = 200
    A = CSRMatrix.from_scipy(sp.diags(
        [-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
        [-1, 0, 1]).tocsr())
    _, n_loose = aggregate_pairwise(A, 1, quality_bound=8.0)
    _, n_tight = aggregate_pairwise(A, 1, quality_bound=1.5)
    assert n_loose <= 0.55 * n           # nearly everything pairs
    assert n_tight == n                  # every pair refused


def test_npair_aggregation_solves(fe):
    A, b, sol = fe
    p = AMGParam(aggregation_type=int(AggregationType.NPAIR))
    h = setup_ua(A, p, structured=False)
    res = amg_solve(h, b, tol=1e-10, maxit=200)
    assert bool(res.converged)
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_npair_falls_back_to_vmb_on_stall():
    """A diagonal matrix cannot pair (every row is G0/singleton); the NPAIR
    path must auto-fall back to VMB (reference: PreAMGSetupUA.c:244-256)."""
    from faspsolver_tpu.formats import CSRMatrix
    from faspsolver_tpu.precond.amg.aggregation import (aggregate,
                                                        aggregate_nsympair)
    import scipy.sparse as sp
    n = 64
    A = CSRMatrix.from_scipy(sp.identity(n, format="csr"))
    _, nagg_raw = aggregate_nsympair(A, 2, 8.0)
    assert nagg_raw == n                 # matching stalls: all singletons
    agg, nagg = aggregate(A, AMGParam(
        aggregation_type=int(AggregationType.NPAIR)), 0.08)
    assert nagg == n                     # VMB on diagonal = singletons too
    assert agg.min() >= 0


def test_ua_level_visits_rule(fe):
    """UA setup records the complexity-based per-level visit counts
    (reference: PreAMGSetupUA.c:391-402), each in {1, 2}, finest = 1."""
    A, _, _ = fe
    h = setup_ua(A, AMGParam(), structured=False)
    if h.num_levels > 2:
        assert h.level_visits
        assert h.level_visits[0] == 1
        assert all(v in (1, 2) for v in h.level_visits)


# ---------------------------------------------------------------------------
# Compiled general-path RS setup (native C++ row kernels)
# ---------------------------------------------------------------------------

def test_native_interp_parity_with_python(fe):
    """Native fasp_interp_std (direct/standard/ext+i) must match the
    Python twins exactly."""
    from faspsolver_tpu import native
    from faspsolver_tpu.precond.amg import interp as I
    from faspsolver_tpu.precond.amg import coarsen_rs as C
    if not native.available():
        pytest.skip("no native toolchain")
    A, _, _ = fe
    S = C.strong_couplings(A, 0.25)
    cf = C.cf_split_rs(A, S)
    for fn in (I.interp_direct, I.interp_standard, I.interp_extended):
        Pn = fn(A, cf, S)
        orig = native.interp_std
        native.interp_std = lambda *a, **k: None
        try:
            Pp = fn(A, cf, S)
        finally:
            native.interp_std = orig
        d = abs(Pn.to_scipy() - Pp.to_scipy())
        assert Pn.nnz == Pp.nnz
        assert (d.max() if d.nnz else 0.0) < 1e-12


def test_rs_general_path_scales():
    """General (unstructured-path) RS-AMG on a 65k-dof problem: setup must
    be compiled-speed (seconds, not minutes) and converge like classical
    AMG.  Guards against Python row loops capping the general path at toy
    sizes."""
    import time
    from faspsolver_tpu.precond.amg import amg_solve, setup_rs
    from faspsolver_tpu.testgen import poisson_2d_manufactured
    A, b, u = poisson_2d_manufactured(255)       # 65025 dof
    t0 = time.time()
    h = setup_rs(A, AMGParam(interpolation_type=int(InterpType.DIRECT)))
    dt = time.time() - t0
    assert dt < 30.0                             # CPU VM with 2x noise
    res = amg_solve(h, jnp.asarray(b), tol=1e-8, maxit=25)
    assert bool(res.converged)
    assert int(res.iters) <= 15
    assert np.max(np.abs(np.asarray(res.x) - u)) < 1e-6


def test_cr_coarsening_native_gs(fe):
    """CR splitting (native F-point GS habituation sweeps) yields a usable
    splitting on FE-3969."""
    from faspsolver_tpu.precond.amg import coarsen_rs as C
    from faspsolver_tpu.constants import CGPT
    A, _, _ = fe
    S = C.strong_couplings(A, 0.25)
    cf = C.cf_split_cr(A, S)
    ratio = (cf == CGPT).sum() / A.nrow
    assert 0.05 < ratio < 0.9


def test_sa_near_kernel_tentative_p(fe):
    """setup_sa(nk=...) carries the basis exactly through the tentative
    prolongation (P_tent B_coarse = B, orthonormal per-aggregate columns)
    and converges in the SA golden regime (reference: near_kernel_basis,
    fasp.h:849-852)."""
    from faspsolver_tpu.precond.amg.aggregation import (
        tentative_prolongation_nk)
    rng = np.random.default_rng(0)
    agg = rng.integers(0, 10, size=50)
    B = rng.standard_normal((50, 2))
    P, Bc = tentative_prolongation_nk(agg, 10, B)
    assert np.abs(P.to_scipy() @ Bc - B).max() < 1e-12
    Q = P.to_scipy().toarray()
    assert np.abs(Q.T @ Q - np.eye(20)).max() < 1e-12

    A, b, sol = fe
    h = setup_sa(A, AMGParam(aggregation_type=int(AggregationType.VMB)),
                 nk=np.ones((A.nrow, 1)))
    res = amg_solve(h, b, tol=1e-10, maxit=100)
    assert bool(res.converged)
    assert int(res.iters) <= 68          # SA golden regime (45)
    assert np.max(np.abs(np.asarray(res.x) - sol)) < 1e-4


def test_strength_scale_is_absolute_max():
    """Reference semantics (strong_couplings, PreAMGCoarsenRS.c:324-384):
    the row scale is the largest ABSOLUTE off-diagonal, so a negative
    coupling that is small next to a large positive one is weak."""
    import scipy.sparse as sp

    from faspsolver_tpu.formats import CSRMatrix
    from faspsolver_tpu.precond.amg.coarsen_rs import strong_couplings

    # row 0: offdiags -0.2 and +1.0 -> cut = 0.3*1.0 -> -(-0.2)=0.2 weak
    dense = np.array([[2.0, -0.2, 1.0],
                      [-0.2, 2.0, -1.0],
                      [1.0, -1.0, 2.0]])
    A = CSRMatrix.from_scipy(sp.csr_matrix(dense))
    S = strong_couplings(A, theta=0.3)
    assert S[0].nnz == 0                 # both couplings weak for row 0
    assert S[1, 2] == 1                  # -1.0 > 0.3*1.0 strong
    assert S[2, 1] == 1
    # native and NumPy twins agree
    import faspsolver_tpu.native as native
    orig = native.strength_graph
    native.strength_graph = lambda *a, **k: None
    try:
        S_py = strong_couplings(A, theta=0.3)
    finally:
        native.strength_graph = orig
    assert (S != S_py).nnz == 0


def test_steam2_amg_degrades_to_exact_coarse_solve():
    """steam2 (all-negative diagonal, dominant positive couplings) has an
    (almost) empty strength graph under the reference's abs-max row scale;
    RS_C1 removes empty-strength rows from the splitting, coarsening finds
    no C variables, and setup gracefully keeps a single level whose coarse
    solver is exact — the reference's own regression passes the same way
    (test/out/reg_mm.out: 'Classical AMG setup costs 0.0001 seconds',
    2 iters to 3.4e-16)."""
    import jax.numpy as jnp

    from faspsolver_tpu.io import read_mtx
    from faspsolver_tpu.precond.amg import setup_rs
    from faspsolver_tpu.precond.amg.solve import amg_solve
    from faspsolver_tpu.utils.params import AMGParam

    A = read_mtx("/root/reference/data/steam2.mtx")
    x_exact = np.ones(A.nrow)
    b = A.matvec(x_exact)
    hier = setup_rs(A, AMGParam(maxit=20, tol=1e-10))
    assert hier.num_levels == 1
    res = amg_solve(hier, jnp.asarray(b), tol=1e-10, maxit=20)
    assert np.abs(np.asarray(res.x) - x_exact).max() < 1e-4


def test_c1_filter_drops_in_edges_of_empty_rows():
    """RS_C1 (fasp.h:64): a point with an empty strength row is ISPT and
    must not be selected as a C point — its in-edges are dropped before
    splitting (the reference's splitting skips ISPT neighbors)."""
    import scipy.sparse as sp

    from faspsolver_tpu.constants import CGPT, ISPT
    from faspsolver_tpu.precond.amg.coarsen_rs import _c1_filter

    # point 2 has an empty row but many in-edges
    S = sp.csr_matrix(np.array([[0, 1, 1],
                                [1, 0, 1],
                                [0, 0, 0]], dtype=float))
    S2, empty = _c1_filter(S)
    assert list(empty) == [False, False, True]
    assert S2[:, 2].nnz == 0             # in-edges to point 2 dropped
    assert S2[0, 1] == 1 and S2[1, 0] == 1


def test_iterative_coarse_solver_large_coarse_level():
    """A hierarchy whose coarsest level exceeds _DENSE_COARSE_LIMIT must
    take the Jacobi-CG IterativeCoarseSolver branch (reference analog:
    fasp_coarse_itsolver, PreMGUtil.inl:25) and still solve."""
    import dataclasses

    from faspsolver_tpu.precond.amg import setup_rs
    from faspsolver_tpu.precond.amg.hierarchy import IterativeCoarseSolver
    from faspsolver_tpu.precond.amg.solve import amg_solve
    from faspsolver_tpu.testgen import poisson_2d
    from faspsolver_tpu.utils.params import AMGParam

    A = poisson_2d(127)                  # 16129 dof
    hier = setup_rs(A, AMGParam(max_levels=2, coarse_dof=100))
    assert hier.num_levels == 2
    assert isinstance(hier.coarse, IterativeCoarseSolver)
    x_exact = np.ones(A.nrow)
    b = A.matvec(x_exact)
    res = amg_solve(hier, jnp.asarray(b), tol=1e-8, maxit=60)
    assert np.abs(np.asarray(res.x) - x_exact).max() < 1e-4
