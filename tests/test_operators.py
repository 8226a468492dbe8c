"""Device operator correctness: ELL / COO / block-ELL / dense vs host matvec."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from faspsolver_tpu.formats import CSRMatrix
from faspsolver_tpu.io import read_bsr, read_mtx
from faspsolver_tpu.ops import (BsrEllOperator, CooOperator, DenseOperator,
                                EllOperator, device_operator)
from faspsolver_tpu.testgen import poisson_2d, poisson_3d

RNG = np.random.default_rng(42)


@pytest.mark.parametrize("op_cls", [EllOperator, CooOperator])
def test_csr_operators_match_host(op_cls):
    A = poisson_2d(9)
    x = RNG.standard_normal(A.ncol)
    ref = A.matvec(x)
    op = op_cls.from_csr(A)
    got = np.asarray(jax.jit(lambda o, v: o(v))(op, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-13)


def test_ell_irregular_rows():
    # matrix with highly variable row lengths incl. an empty row
    dense = np.zeros((7, 7))
    dense[0, :] = 1.0
    dense[2, 3] = 5.0
    dense[4, [0, 6]] = [2.0, -1.0]
    A = CSRMatrix.from_dense(dense)
    x = RNG.standard_normal(7)
    for cls in (EllOperator, CooOperator):
        op = cls.from_csr(A)
        np.testing.assert_allclose(np.asarray(op(jnp.asarray(x))), dense @ x,
                                   rtol=1e-13)


def test_bsr_operator_spe01(refdata):
    A = read_bsr(f"{refdata}/bsrmat_SPE01.dat")
    op = BsrEllOperator.from_bsr(A)
    x = RNG.standard_normal(A.nrow)
    ref = A.matvec(x)
    got = np.asarray(jax.jit(lambda o, v: o(v))(op, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_dense_operator():
    A = poisson_2d(4)
    op = DenseOperator.from_csr(A)
    x = RNG.standard_normal(A.ncol)
    np.testing.assert_allclose(np.asarray(op(jnp.asarray(x))), A.matvec(x),
                               rtol=1e-13)


def test_device_operator_dispatch(refdata):
    small = poisson_2d(4)            # 16 dof -> dense
    assert isinstance(device_operator(small), DenseOperator)
    big = poisson_3d(12)             # banded stencil -> DIA (gather-free)
    from faspsolver_tpu.ops import DiaOperator
    assert isinstance(device_operator(big), DiaOperator)
    assert isinstance(device_operator(big, prefer="ell"), EllOperator)
    mtx = read_mtx(f"{refdata}/nos7.mtx")
    op = device_operator(mtx)
    x = RNG.standard_normal(mtx.ncol)
    np.testing.assert_allclose(np.asarray(op(jnp.asarray(x))), mtx.matvec(x),
                               rtol=1e-11)


def test_operator_is_pytree():
    A = poisson_2d(8)
    op = EllOperator.from_csr(A)
    leaves = jax.tree_util.tree_leaves(op)
    assert len(leaves) == 2  # cols, vals
    # jit with operator as argument compiles and caches
    f = jax.jit(lambda o, v: o(v))
    x = jnp.ones(A.ncol, dtype=op.dtype)
    _ = f(op, x)
    _ = f(op, x + 1)


def test_dia_nd_operator_matches_csr():
    """Grid-aware per-axis-shift SpMV == CSR matvec (2-D and 3-D), and
    the structured hierarchy's fine operator is the nd form."""
    import jax.numpy as jnp
    from faspsolver_tpu.ops import DiaNdOperator
    from faspsolver_tpu.precond.amg.band_algebra import BandMatrix
    from faspsolver_tpu.testgen import poisson_2d, poisson_3d
    rng = np.random.default_rng(5)
    for A, dims in ((poisson_2d(13, 9), (9, 13)),
                    (poisson_3d(6, 5, 4), (4, 5, 6))):
        B = BandMatrix.from_csr(A, dims)
        op = B.to_nd_operator()
        assert isinstance(op, DiaNdOperator)
        x = rng.standard_normal(A.nrow)
        np.testing.assert_allclose(np.asarray(op(jnp.asarray(x))),
                                   A.matvec(x), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(op.diagonal()), A.diagonal(),
                                   rtol=1e-14)


def test_const_stencil_5pt_matches_scipy():
    """A 2-D constant-coefficient 5-point StencilNdOperator (scalar bands,
    zero Dirichlet halo) on a 128-wide grid equals scipy's CSR product."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from faspsolver_tpu.ops.operators import StencilNdOperator

    ny, nx = 96, 128
    coords = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    cvals = (-0.25, -0.24, 1.01, -0.26, -0.23)
    op = StencilNdOperator(
        tuple(jnp.full((1, 1), c, jnp.float64) for c in cvals), coords,
        (ny, nx))
    ex, ey = sp.eye(nx), sp.eye(ny)
    A = (cvals[2] * sp.eye(ny * nx)
         + sp.kron(ey, cvals[1] * sp.eye(nx, k=-1)
                   + cvals[3] * sp.eye(nx, k=1))
         + sp.kron(cvals[0] * sp.eye(ny, k=-1)
                   + cvals[4] * sp.eye(ny, k=1), ex)).tocsr()
    x = np.random.default_rng(3).standard_normal(ny * nx)
    np.testing.assert_allclose(np.asarray(op(jnp.asarray(x))), A @ x,
                               rtol=1e-13, atol=1e-14)


def test_refiner_cast_b_f32_upload():
    """cast_b=True: the packed resident refiner accepts an f32 b, promotes
    on device, and still converges to tol=1e-6 (exact-b verification)."""
    import jax
    import jax.numpy as jnp

    from faspsolver_tpu.precond.amg import setup_structured
    from faspsolver_tpu.solvers.refine import make_resident_refiner_packed
    from faspsolver_tpu.testgen import poisson_2d
    from faspsolver_tpu.utils.params import AMGParam

    A = poisson_2d(63)
    b = A.matvec(np.ones(A.nrow))
    hier = setup_structured(A, AMGParam(coarse_dof=100), dtype=jnp.float32,
                            smooth_p=True, keep_f64_fine=True, pack=True)
    assert hier is not None and hier.p64 is not None
    runner = make_resident_refiner_packed(hier, tol=1e-6, max_rounds=4,
                                          maxit_inner=40, cast_b=True)
    comp = runner.compile(jax.ShapeDtypeStruct((A.nrow,), jnp.float32))
    x, rr, rnd, it = comp(jnp.asarray(b, jnp.float32))
    ver = float(np.linalg.norm(b - A.matvec(np.asarray(x)))
                / np.linalg.norm(b))
    assert ver < 1e-6


def _f32_matrix_dots(jaxpr):
    """dot_general equations with an f32 operand of rank >= 2 (matrix
    products a GPU may run in TF32), searched through nested jaxprs."""
    found = []
    for eqn in jaxpr.eqns:
        avals = [v.aval for v in eqn.invars]
        if (eqn.primitive.name == "dot_general"
                and any(a.dtype == jnp.float32 for a in avals)
                and any(a.ndim >= 2 for a in avals)):
            found.append(eqn)
        for val in eqn.params.values():
            for sub in (val if isinstance(val, (tuple, list)) else (val,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _f32_matrix_dots(inner)
    return found


def _factored_band_f32():
    from faspsolver_tpu.ops.operators import FactoredBand, factor_band_2d
    groups = np.ones(40, np.int64)
    groups[0], groups[-1] = 0, 2
    core = RNG.standard_normal((3, 3)).astype(np.float32)
    band = core[groups][:, groups]
    return band, FactoredBand(*(jnp.asarray(a)
                                for a in factor_band_2d(band)))


def _precision_case(name):
    """(function, example args) for one f32 product site."""
    from faspsolver_tpu.krylov import gcr, gmres, vfgmres

    if name in ("factored_apply", "factored_materialize"):
        band, fb = _factored_band_f32()
        y = jnp.zeros(band.shape, jnp.float32)
        if name == "factored_apply":
            return fb.apply, (y, y + 1)
        return lambda: fb.materialize(), ()
    A = poisson_2d(12)
    b = jnp.asarray(A.matvec(np.ones(A.nrow)), jnp.float32)
    if name == "nullspace_cycle":
        import dataclasses

        from faspsolver_tpu.precond.amg import mgcycle, setup_sa
        from faspsolver_tpu.precond.amg.hierarchy import NearKernel
        from faspsolver_tpu.utils.params import AMGParam
        h = setup_sa(A, AMGParam(coarse_dof=20), dtype=jnp.float32)
        nk = NearKernel(jnp.ones((A.nrow, 2), jnp.float32),
                        jnp.eye(2, dtype=jnp.float32))
        h = dataclasses.replace(h, levels=(
            dataclasses.replace(h.levels[0], nk=nk),) + h.levels[1:])
        return lambda r: mgcycle(h, r), (b,)
    op = device_operator(A, dtype=jnp.float32)
    solver = {"gmres": gmres, "vfgmres": vfgmres, "gcr": gcr}[name]
    return lambda r: solver(op, r, tol=1e-6, maxit=20, restart=5).x, (b,)


@pytest.mark.parametrize("name", ["factored_apply", "factored_materialize",
                                  "gmres", "vfgmres", "gcr",
                                  "nullspace_cycle"])
def test_f32_products_ask_for_highest_precision(name):
    """Every f32 matrix product on these paths passes Precision.HIGHEST:
    a default-precision f32 matmul may run in TF32 on a GPU."""
    fn, args = _precision_case(name)
    dots = _f32_matrix_dots(jax.make_jaxpr(fn)(*args).jaxpr)
    assert dots, "no f32 matrix product traced"
    hi = jax.lax.Precision.HIGHEST
    for eqn in dots:
        assert eqn.params["precision"] == (hi, hi), eqn


@pytest.mark.gpu
def test_factored_band_materialize_bit_exact_on_gpu(gpu):
    """On the card the selector products reproduce the band exactly in
    f32 (TF32 would round its entries); chip_smoke.py checks the same at
    4095^2."""
    band, fb = _factored_band_f32()
    assert np.array_equal(np.asarray(fb.materialize()), band)
