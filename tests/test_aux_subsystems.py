"""Aux subsystems: extended IO, graphics, checkpoint, CSRL, maxeig,
Kaczmarz (SURVEY.md §5 observability/persistence checklist)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from faspsolver_tpu.constants import SmootherType
from faspsolver_tpu.formats import CSRLMatrix
from faspsolver_tpu.io import (read_coovec_bin, read_mesh, read_mtx,
                               read_str, write_coovec_bin, write_mtx,
                               write_str)
from faspsolver_tpu.ops import device_operator
from faspsolver_tpu.ops.eigen import maxeig
from faspsolver_tpu.precond import AMGPrecond
from faspsolver_tpu.precond.amg import setup_structured
from faspsolver_tpu.precond.amg.smoothers import build_smoother, kaczmarz_sweep
from faspsolver_tpu.krylov import pcg
from faspsolver_tpu.testgen import poisson_2d, poisson_2d_manufactured
from faspsolver_tpu.utils import (grid2d_plot, load_hierarchy, load_iterate,
                                  save_hierarchy, save_iterate, spy_plot)
from faspsolver_tpu.utils.params import AMGParam

RNG = np.random.default_rng(5)


def test_csrl_roundtrip_and_matvec():
    A = poisson_2d(11)
    L = CSRLMatrix.from_csr(A)
    x = RNG.standard_normal(A.ncol)
    np.testing.assert_allclose(L.matvec(x), A.matvec(x), rtol=1e-13)
    np.testing.assert_allclose(L.to_csr().to_dense(), A.to_dense())
    assert L.num_groups >= 2          # interior vs boundary row lengths


def test_maxeig_power_method():
    import scipy.sparse.linalg as spl
    A = poisson_2d(14)
    lam = maxeig(A, iters=200, tol=1e-9)
    lam_ref = float(spl.eigsh(A.to_scipy(), k=1, which="LA",
                              return_eigenvectors=False)[0])
    assert abs(lam - lam_ref) / lam_ref < 0.02


def test_binary_coo_roundtrip(tmp_path):
    A = poisson_2d(9)
    b = RNG.standard_normal(A.nrow)
    for endian in ("little", "big"):
        mp, rp = str(tmp_path / f"m_{endian}"), str(tmp_path / f"r_{endian}")
        write_coovec_bin(mp, A, rp, b, endian=endian)
        A2, b2 = read_coovec_bin(mp, rp, endian=endian)
        np.testing.assert_allclose(A2.to_dense(), A.to_dense())
        np.testing.assert_allclose(b2, b)


def test_mtx_writer_roundtrip(tmp_path):
    A = poisson_2d(7)
    p = str(tmp_path / "a.mtx")
    write_mtx(p, A)
    np.testing.assert_allclose(read_mtx(p).to_dense(), A.to_dense())


def test_str_writer_roundtrip(tmp_path):
    from test_formats_families import _make_str
    A = _make_str()
    p = str(tmp_path / "a.str")
    write_str(p, A)
    B = read_str(p)
    x = RNG.standard_normal(A.nrow)
    np.testing.assert_allclose(B.matvec(x), A.matvec(x), rtol=1e-12)


def test_reference_mesh_reads(refdata):
    mesh = read_mesh(f"{refdata}/mesh.dat")
    assert mesh.num_nodes == 9 and mesh.num_elems == 8
    from faspsolver_tpu.testgen.fem import _p1_geometry
    area, _ = _p1_geometry(mesh)
    assert abs(area.sum() - 1.0) < 1e-12


def test_spy_and_grid_plots(tmp_path):
    A = poisson_2d(10)
    p1, p2 = str(tmp_path / "spy.bmp"), str(tmp_path / "grid.bmp")
    spy_plot(p1, A)
    grid2d_plot(p2, RNG.standard_normal(100), (10, 10))
    for p in (p1, p2):
        with open(p, "rb") as f:
            assert f.read(2) == b"BM"
        assert os.path.getsize(p) > 100


def test_hierarchy_checkpoint_roundtrip(tmp_path):
    A, b, xex = poisson_2d_manufactured(24)
    h = setup_structured(A, AMGParam(coarse_dof=60), smooth_p=True)
    p = str(tmp_path / "h.npz")
    save_hierarchy(p, h)
    h2 = load_hierarchy(p)
    r = pcg(device_operator(A, prefer="dia"), jnp.asarray(b),
            M=AMGPrecond(h2), tol=1e-10, maxit=100)
    assert bool(r.converged)
    assert np.abs(np.asarray(r.x) - xex).max() < 1e-8


def test_iterate_checkpoint(tmp_path):
    p = str(tmp_path / "it.npz")
    x = RNG.standard_normal(50)
    save_iterate(p, x, 7, 1.5e-9)
    x2, it, rr = load_iterate(p)
    np.testing.assert_allclose(x2, x)
    assert it == 7 and abs(rr - 1.5e-9) < 1e-20


def test_kaczmarz_reduces_residual():
    A, b, _ = poisson_2d_manufactured(12)
    sm = build_smoother(A, int(SmootherType.GS))
    op = device_operator(A, prefer="ell")
    x = jnp.zeros(A.nrow)
    r0 = np.linalg.norm(b)
    for _ in range(60):
        x = kaczmarz_sweep(sm, op, x, jnp.asarray(b))
    r = np.linalg.norm(b - A.matvec(np.asarray(x)))
    assert r < 0.9 * r0


def test_benchmark_harness_smoke():
    """The lMVU harness scores a tiny problem end-to-end."""
    from faspsolver_tpu.benchmark.harness import (compute_lmvu,
                                                  score_problem,
                                                  _solver_factory)
    from faspsolver_tpu.testgen import poisson_2d
    lmvu = compute_lmvu(n_base=24, iters=10)
    assert lmvu > 0
    A = poisson_2d(24)
    b = A.matvec(np.ones(A.nrow))
    r = score_problem("tiny", A, b, _solver_factory("cg"), lmvu)
    assert r.converged
    assert r.score > 0


def test_deep_w_cycle_hierarchy_compile_guard():
    """>=10-level W-cycle hierarchy must trace/compile bounded (the
    _W_UNROLL_CAP policy: levels past the cap degrade to V-visits) and
    converge."""
    import time
    import jax.numpy as jnp
    from faspsolver_tpu.constants import CycleType, SmootherType
    from faspsolver_tpu.precond.amg import amg_solve, setup_rs
    from faspsolver_tpu.precond.amg.cycles import _W_UNROLL_CAP, _visits
    from faspsolver_tpu.utils.params import AMGParam
    # 1-D Laplacian: RS coarsens 2:1, so depth grows without problem
    # size — the guard targets hierarchy DEPTH, not dof count
    import scipy.sparse as sp
    from faspsolver_tpu.formats import CSRMatrix
    n = 4096
    A = CSRMatrix.from_scipy(sp.diags(
        [-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
        [-1, 0, 1]).tocsr() * (n + 1) ** 2)
    g = np.arange(1, n + 1) / (n + 1)
    u = np.sin(np.pi * g)
    b = A.to_scipy() @ u
    h = setup_rs(A, AMGParam(cycle_type=int(CycleType.W),
                             smoother=int(SmootherType.GS),
                             coarse_dof=4, max_levels=20))
    assert h.num_levels >= 10
    # the visit cap bounds traced coarse-visits: sum over levels of
    # prod(visits) must stay polynomial, not 2^levels
    total = 1
    for l in range(h.num_levels - 1):
        total *= _visits(int(CycleType.W), l)
    assert total <= 2 ** _W_UNROLL_CAP
    t0 = time.time()
    res = amg_solve(h, jnp.asarray(b), tol=1e-8, maxit=20)
    dt = time.time() - t0
    assert bool(res.converged)
    assert np.max(np.abs(np.asarray(res.x) - u)) < 1e-6
    assert dt < 240.0      # compile+solve bounded on the slow remote path
