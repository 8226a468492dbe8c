"""Structured (gather-free) AMG path + band algebra + native kernels.

SURVEY.md §7: the structured fast path must be exact — band-space Galerkin
products are checked against scipy sparse triple products, and the native
C++ kernels against their Python twins.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from faspsolver_tpu.constants import SmootherType
from faspsolver_tpu.formats import CSRMatrix
from faspsolver_tpu.krylov import pcg
from faspsolver_tpu.ops import DiaOperator, device_operator
from faspsolver_tpu.precond import AMGPrecond
from faspsolver_tpu.precond.amg import detect_dims, setup_structured
from faspsolver_tpu.precond.amg.band_algebra import BandMatrix
from faspsolver_tpu.precond.amg.structured import pair_agg_map
from faspsolver_tpu.testgen import (poisson_2d, poisson_2d_manufactured,
                                    poisson_3d, poisson_3d_manufactured)
from faspsolver_tpu.utils.params import AMGParam

RNG = np.random.default_rng(3)


def test_dia_operator_matches_csr():
    A = poisson_2d(13, 7)
    op = DiaOperator.from_csr(A)
    x = RNG.standard_normal(A.ncol)
    np.testing.assert_allclose(np.asarray(op(jnp.asarray(x))), A.matvec(x),
                               rtol=1e-13)


def test_detect_dims():
    from faspsolver_tpu.ops import dia_bands_from_csr
    A = poisson_2d(12, 20)
    offs, _ = dia_bands_from_csr(A)
    assert detect_dims(offs, A.nrow) == (20, 12)
    A3 = poisson_3d(5, 6, 7)
    offs3, _ = dia_bands_from_csr(A3)
    assert detect_dims(offs3, A3.nrow) == (7, 6, 5)


def test_band_matrix_roundtrip_and_rap():
    A = poisson_2d(9, 11)
    B = BandMatrix.from_csr(A, (11, 9))
    assert B is not None
    np.testing.assert_allclose(B.to_csr().to_dense(), A.to_dense())
    # band pair_rap == scipy P^T A P for boolean grouping, every axis/factor
    for ax in (0, 1):
        for s in (2, 3):
            agg, nagg = pair_agg_map((11, 9), ax, s)
            P = sp.csr_matrix((np.ones(A.nrow), (np.arange(A.nrow), agg)),
                              shape=(A.nrow, nagg))
            ref = (P.T @ A.to_scipy() @ P).toarray()
            got = B.pair_rap(ax, s).to_dense()
            np.testing.assert_allclose(got, ref, atol=1e-12)


def test_band_matrix_rap_3d():
    """3-D band pair_rap must equal scipy P^T A P on every axis/factor —
    catches native-kernel indexing bugs the AMG convergence tests mask."""
    A = poisson_3d(6, 5, 4)
    B = BandMatrix.from_csr(A, (4, 5, 6))
    m = A.to_scipy()
    np.testing.assert_allclose(B.matmul(B).to_dense(), (m @ m).toarray(),
                               atol=1e-10)
    for ax in (0, 1, 2):
        for s in (2, 3):
            agg, nagg = pair_agg_map((4, 5, 6), ax, s)
            P = sp.csr_matrix((np.ones(A.nrow), (np.arange(A.nrow), agg)),
                              shape=(A.nrow, nagg))
            ref = (P.T @ m @ P).toarray()
            np.testing.assert_allclose(B.pair_rap(ax, s).to_dense(), ref,
                                       atol=1e-12)


@pytest.mark.parametrize("dims", [(11, 9), (4, 5, 6)])
@pytest.mark.parametrize("omega", [0.0, 0.67])
def test_fused_smoothed_rap_matches_scipy(dims, omega):
    """The fused native smoothed-RAP kernel must equal the explicit scipy
    triple product P^T (I - wAD^-1) A (I - wD^-1A) P with P the boolean
    s-per-axis grouping over every axis — same contract as pair_rap."""
    A = poisson_2d(dims[1], dims[0]) if len(dims) == 2 else (
        poisson_3d(dims[2], dims[1], dims[0]))
    B = BandMatrix.from_csr(A, dims)
    m = A.to_scipy()
    d = m.diagonal()
    dinv = 1.0 / np.where(d != 0.0, d, 1.0)
    for s in (2, 3):
        got_B = B.smoothed_rap_all_axes(dinv if omega else None, omega, s)
        if got_B is None:
            pytest.skip("native kernel unavailable")
        n = A.nrow
        P = _grouping_P(dims, s)
        S = sp.identity(n) - omega * sp.diags(dinv) @ m
        ST = sp.identity(n) - omega * m @ sp.diags(dinv)
        ref = (P.T @ (ST @ m @ S) @ P).toarray()
        np.testing.assert_allclose(got_B.to_dense(), ref, atol=1e-10)


def _grouping_P(dims, s):
    """Boolean s-per-axis grouping prolongation over every axis."""
    idx = np.indices(dims).reshape(len(dims), -1)
    cdims = tuple(-(-d // s) for d in dims)
    cidx = idx // s
    cols = np.ravel_multi_index(cidx, cdims)
    n = int(np.prod(dims))
    return sp.csr_matrix((np.ones(n), (np.arange(n), cols)),
                         shape=(n, int(np.prod(cdims))))


def test_band_matmul_and_transpose():
    A = poisson_2d(8)
    B = BandMatrix.from_csr(A, (8, 8))
    m = A.to_scipy()
    np.testing.assert_allclose(B.matmul(B).to_dense(), (m @ m).toarray(),
                               atol=1e-10)
    np.testing.assert_allclose(B.transpose().to_dense(), m.T.toarray(),
                               atol=1e-12)
    d = RNG.standard_normal(A.nrow)
    np.testing.assert_allclose(B.scale_rows(d).to_dense(),
                               (sp.diags(d) @ m).toarray(), atol=1e-12)
    np.testing.assert_allclose(B.scale_cols(d).to_dense(),
                               (m @ sp.diags(d)).toarray(), atol=1e-12)


def test_band_from_csr_rejects_wrap():
    # a matrix with an entry that flat-offset-decomposes wrongly (row wrap)
    m = sp.lil_matrix((16, 16))
    m.setdiag(2.0)
    m[3, 4] = -1.0      # (0,3)->(1,0) on a 4x4 grid: a wrap entry
    B = BandMatrix.from_csr(CSRMatrix.from_scipy(m.tocsr()), (4, 4))
    assert B is None


@pytest.mark.parametrize("smooth_p", [False, True])
@pytest.mark.parametrize("nx", [24, 17])
def test_structured_amg_2d(smooth_p, nx):
    A, b, xex = poisson_2d_manufactured(nx)
    hier = setup_structured(
        A, AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                    polynomial_degree=2, coarse_dof=60), smooth_p=smooth_p)
    assert hier is not None
    r = pcg(device_operator(A, prefer="dia"), jnp.asarray(b),
            M=AMGPrecond(hier), tol=1e-10, maxit=200)
    assert bool(r.converged)
    assert np.abs(np.asarray(r.x) - xex).max() < 1e-8


def test_structured_amg_3d_rbgs():
    A, b, xex = poisson_3d_manufactured(10)
    hier = setup_structured(A, AMGParam(smoother=int(SmootherType.GS),
                                        coarse_dof=60), smooth_p=True)
    assert hier is not None
    # fine-level smoother must be the exact red-black GS (bipartite 7-pt)
    assert hier.levels[0].smoother.kind == int(SmootherType.RBGS)
    r = pcg(device_operator(A, prefer="dia"), jnp.asarray(b),
            M=AMGPrecond(hier), tol=1e-10, maxit=200)
    assert bool(r.converged)
    assert np.abs(np.asarray(r.x) - xex).max() < 1e-8


def test_structured_transfer_adjoint():
    """R must be the exact transpose of P (UA boolean transfers)."""
    A = poisson_2d(12, 10)
    hier = setup_structured(A, AMGParam(coarse_dof=40), smooth_p=False)
    lvl = hier.levels[0]
    nf = lvl.A.shape[0]
    nc = hier.levels[1].A.shape[0]
    xc = RNG.standard_normal(nc)
    yf = RNG.standard_normal(nf)
    lhs = float(jnp.dot(jnp.asarray(yf), lvl.P(jnp.asarray(xc))))
    rhs = float(jnp.dot(lvl.R(jnp.asarray(yf)), jnp.asarray(xc)))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)


def test_csr_canonicalization_diag_first():
    """Reference files store the diagonal first per row; construction must
    canonicalize so scipy views can never permute data out from under us."""
    indptr = np.array([0, 3, 5])
    indices = np.array([0, 2, 1, 1, 0])     # diag-first, unsorted
    data = np.array([4.0, -1.0, -2.0, 5.0, -3.0])
    A = CSRMatrix(indptr, indices, data, (2, 3))
    dense = np.array([[4.0, -2.0, -1.0], [-3.0, 5.0, 0.0]])
    np.testing.assert_allclose(A.to_dense(), dense)
    assert all(np.all(np.diff(A.indices[s:e]) > 0)
               for s, e in zip(A.indptr[:-1], A.indptr[1:]))


# ---------------------------------------------------------------------------
# native kernels vs python twins
# ---------------------------------------------------------------------------

def test_native_iluk_parity():
    from faspsolver_tpu import native
    if not native.available():
        pytest.skip("no native toolchain")
    from faspsolver_tpu.precond.ilu import iluk_factor
    A, _, _ = poisson_2d_manufactured(12)
    for lfil in (0, 2):
        Lp, Up = iluk_factor(A, lfil)
        Ln, Un = native.iluk(A, lfil)
        assert abs((Lp - Ln)).max() < 1e-12 if (Lp - Ln).nnz else True
        assert abs((Up - Un)).max() < 1e-10 if (Up - Un).nnz else True
        assert Ln.nnz == Lp.nnz and Un.nnz == Up.nnz


def test_native_color_and_levels():
    from faspsolver_tpu import native
    if not native.available():
        pytest.skip("no native toolchain")
    A = poisson_2d(9)
    m = A.to_scipy().copy()
    m.setdiag(0)
    m.eliminate_zeros()
    color, nc = native.greedy_color(m.indptr, m.indices, A.nrow)
    rows = np.repeat(np.arange(A.nrow), np.diff(m.indptr))
    assert (color[rows] != color[m.indices]).all()
    assert nc == 2                      # 5-point stencil is bipartite
    # level schedule of a lower factor is a topological order
    from faspsolver_tpu.precond.ilu import iluk_factor
    L, _ = iluk_factor(A, 0)
    depth, nlev = native.level_schedule(L.indptr, L.indices, A.nrow, True)
    coo = L.tocoo()
    strict = coo.col < coo.row
    assert (depth[coo.row[strict]] > depth[coo.col[strict]]).all()


def test_native_ilut_preconditions():
    from faspsolver_tpu import native
    if not native.available():
        pytest.skip("no native toolchain")
    A, b, xex = poisson_2d_manufactured(16)
    from faspsolver_tpu import solvers
    from faspsolver_tpu.utils.params import ILUParam, ITSParam
    from faspsolver_tpu.constants import ILUType
    r = solvers.krylov_ilu(A, b, its=ITSParam(tol=1e-10, maxit=200),
                           ilu=ILUParam(ILU_type=int(ILUType.ILUT),
                                        ILU_lfil=5))
    assert bool(r.converged)
    assert np.abs(np.asarray(r.x) - xex).max() < 1e-8


def test_input_matrix_never_mutated():
    A, b, _ = poisson_2d_manufactured(12)
    data0 = A.data.copy()
    idx0 = A.indices.copy()
    from faspsolver_tpu import solvers
    from faspsolver_tpu.utils.params import ITSParam
    solvers.krylov_ilu(A, b, its=ITSParam(tol=1e-8, maxit=50))
    solvers.krylov_amg(A, b, its=ITSParam(tol=1e-8, maxit=50))
    assert np.array_equal(A.data, data0)
    assert np.array_equal(A.indices, idx0)


# ---------------------------------------------------------------------------
# round 3: compressed stencil operators + native DIA extraction +
# device-resident refinement
# ---------------------------------------------------------------------------

def test_factor_band_exact():
    from faspsolver_tpu.ops.operators import factor_band_2d
    rng = np.random.default_rng(3)
    # constant band -> 3-entry factorization
    band = np.full((40, 50), -1.25)
    rs, core, cs = factor_band_2d(band)
    assert rs.size + core.size + cs.size <= 6
    rec = rs @ (core @ cs)
    assert np.array_equal(np.broadcast_to(rec, band.shape), band)
    # Galerkin-like band: interior constant, distinct boundary rows/cols
    band = np.full((40, 50), 2.0)
    band[0, :] = 3.0
    band[-1, :] = 4.0
    band[:, 0] *= 0.5
    band[:, -2:] *= 0.25
    fac = factor_band_2d(band)
    assert fac is not None
    rs, core, cs = fac
    rec = np.broadcast_to(rs @ (core @ cs), band.shape)
    assert np.array_equal(rec, band)      # EXACT, not allclose
    # random band: incompressible -> None
    assert factor_band_2d(rng.standard_normal((40, 50))) is None


def test_stencil_operator_matches_dia_nd():
    from faspsolver_tpu.precond.amg.structured import _grid_operator
    A = poisson_2d(33)
    B = BandMatrix.from_csr(A, (33, 33))
    op_nd = B.to_nd_operator()
    op_st = B.to_stencil_operator()
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.nrow)
    y_nd = np.asarray(op_nd(jnp.asarray(x)))
    y_st = np.asarray(op_st(jnp.asarray(x)))
    assert np.array_equal(y_nd, y_st)
    assert np.array_equal(np.asarray(op_nd.diagonal()),
                          np.asarray(op_st.diagonal()))
    # coarse Galerkin level stays exact through compression
    d = B.diagonal()
    dinv = 1.0 / np.where(d != 0, d, 1.0)
    Bc = B.smoothed_rap_all_axes(dinv, 0.67, 3)
    xc = rng.standard_normal(Bc.n)
    yc_nd = np.asarray(Bc.to_nd_operator()(jnp.asarray(xc)))
    yc_st = np.asarray(Bc.to_stencil_operator()(jnp.asarray(xc)))
    assert np.array_equal(yc_nd, yc_st)


def test_native_dia_extraction_parity():
    from faspsolver_tpu import native
    if not native.available():
        pytest.skip("native library unavailable")
    for mat in (poisson_2d(29), poisson_3d(7)):
        nat = native.dia_from_csr(mat)
        assert nat is not None
        n = mat.nrow
        rows = np.repeat(np.arange(n, dtype=np.int64), mat.row_nnz())
        off = mat.indices.astype(np.int64) - rows
        offsets = np.unique(off)
        pos = np.searchsorted(offsets, off)
        bands = np.zeros((len(offsets), n), dtype=mat.data.dtype)
        bands[pos, rows] = mat.data
        assert np.array_equal(nat[0], offsets)
        assert np.array_equal(nat[1], bands)


def test_resident_refiner_converges():
    from faspsolver_tpu.solvers import solve_refined_resident
    A = poisson_2d(63)
    param = AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                     polynomial_degree=2, coarse_dof=500,
                     tentative_smooth=0.67)
    hier = setup_structured(A, param, dtype=jnp.float32, smooth_p=True,
                            keep_f64_fine=True)
    assert hier is not None and hier.fine64 is not None
    b = A.matvec(np.ones(A.nrow))
    res = solve_refined_resident(hier, b, tol=1e-8)
    assert res.converged
    # the device-reported relres must equal the true host f64 residual
    r = b - A.matvec(res.x)
    host = float(np.linalg.norm(r) / np.linalg.norm(b))
    assert host < 1e-8
    assert abs(host - res.relres) <= 1e-12 + 1e-6 * host


def test_compact_vec():
    from faspsolver_tpu.precond.amg.structured import _compact_vec
    v = np.full(100, 3.5)
    c = _compact_vec(v)
    assert c.shape == (1,) and c[0] == 3.5
    w = np.arange(5.0)
    assert _compact_vec(w) is w
