"""Finite-difference Poisson problem generators.

Reference: test/src/FdmPoisson.c (5-point 2D / 7-point 3D generators) and
test/main/testfdm2d.cpp / testfdm3d.cpp.  Used for manufactured-solution
tests and for arbitrarily large scaling benchmarks (shipped SPE01 is tiny;
BASELINE.md directs scaling runs to generated 3D Poisson).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ..formats import CSRMatrix


def poisson_2d(nx: int, ny: int = None, dtype=np.float64
               ) -> CSRMatrix:
    """5-point Laplacian on an nx x ny interior grid of the unit square,
    Dirichlet boundary eliminated; scaled by 1/h^2 like the reference FDM
    generator (test/src/FdmPoisson.c)."""
    ny = ny if ny is not None else nx
    hx2 = float((nx + 1) ** 2)
    hy2 = float((ny + 1) ** 2)
    Tx = sp.diags([-hx2, 2 * hx2, -hx2], [-1, 0, 1], shape=(nx, nx))
    Ty = sp.diags([-hy2, 2 * hy2, -hy2], [-1, 0, 1], shape=(ny, ny))
    A = (sp.kron(sp.eye(ny), Tx) + sp.kron(Ty, sp.eye(nx))).tocsr()
    A.eliminate_zeros()        # scipy kron goes through BSR: drop the
    A.sort_indices()           # explicit zeros its dense blocks introduce
    return CSRMatrix.from_scipy(A.astype(dtype))


def poisson_3d(nx: int, ny: int = None, nz: int = None, dtype=np.float64
               ) -> CSRMatrix:
    """7-point Laplacian on the unit cube, Dirichlet eliminated."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx

    def t(n):
        h2 = float((n + 1) ** 2)
        return sp.diags([-h2, 2 * h2, -h2], [-1, 0, 1], shape=(n, n))

    Ix, Iy, Iz = sp.eye(nx), sp.eye(ny), sp.eye(nz)
    A = (sp.kron(Iz, sp.kron(Iy, t(nx)))
         + sp.kron(Iz, sp.kron(t(ny), Ix))
         + sp.kron(t(nz), sp.kron(Iy, Ix))).tocsr()
    A.eliminate_zeros()
    A.sort_indices()
    return CSRMatrix.from_scipy(A.astype(dtype))


def poisson_2d_manufactured(nx: int, ny: int = None
                            ) -> Tuple[CSRMatrix, np.ndarray, np.ndarray]:
    """(A, b, u_exact) with u = sin(pi x) sin(pi y) sampled on the grid and
    b = A u (discrete manufactured solution — exact to machine precision,
    the same trick regression.c:118-126 uses with random solutions)."""
    ny = ny if ny is not None else nx
    A = poisson_2d(nx, ny)
    xs = np.arange(1, nx + 1) / (nx + 1)
    ys = np.arange(1, ny + 1) / (ny + 1)
    # NOT sin*sin: that is the lowest eigenmode of the discrete Laplacian,
    # so b would be an eigenvector and every Krylov solver would converge in
    # one iteration — a degenerate test.  Mix modes instead.
    X, Y = np.meshgrid(xs, ys)
    u = (np.sin(np.pi * X) * np.sin(np.pi * Y)
         + 0.5 * X * (1 - X) * np.exp(Y)).reshape(-1)
    b = A.matvec(u)
    return A, b, u


def poisson_3d_manufactured(nx: int
                            ) -> Tuple[CSRMatrix, np.ndarray, np.ndarray]:
    A = poisson_3d(nx)
    g = np.arange(1, nx + 1) / (nx + 1)
    s = np.sin(np.pi * g)
    q = g * (1 - g)       # mix in a non-eigenmode (see 2D note)
    u = (np.einsum("i,j,k->ijk", s, s, s)
         + 0.5 * np.einsum("i,j,k->ijk", q, s, q)).reshape(-1)
    b = A.matvec(u)
    return A, b, u


def block_poisson_3d(nx: int, ny: int = 0, nz: int = 0, nb: int = 3,
                     coupling: float = 0.1):
    """Block-expanded 3-D Poisson: each scalar stencil entry becomes an
    nb x nb SPD block ``a_ij * (I + coupling*(1-I))`` — a generated BSR
    system large enough for real multilevel block-AMG exercises (the
    shipped SPE01 sample is only 302 blocks; BASELINE.md directs scaling
    runs to generated 3-D systems, reference generator test/src/FdmPoisson.c
    + testfdm3d.cpp)."""
    from ..formats import BSRMatrix

    A = poisson_3d(nx, ny or nx, nz or nx)
    blk = np.eye(nb) + coupling * (np.ones((nb, nb)) - np.eye(nb))
    data = A.data[:, None, None] * blk[None]
    return BSRMatrix(A.indptr.copy(), A.indices.copy(),
                     np.ascontiguousarray(data), (A.nrow, A.ncol))


# ---------------------------------------------------------------------------
# Benchmark-corpus families: the reference scores up
# to 235 SuiteSparse problems (benchmark/input.dat); with no network the
# corpus DIVERSITY is matched by generated families — anisotropy, jump
# coefficients, convection-diffusion (nonsymmetric), stretched grids —
# the problem classes that stress coarsening, smoothing, and
# nonsymmetric Krylov in the same ways.
# ---------------------------------------------------------------------------

def anisotropic_2d(nx: int, eps: float, ny: int = None,
                   dtype=np.float64) -> CSRMatrix:
    """-u_xx - eps * u_yy on the unit square (5-point), Dirichlet
    eliminated.  eps far from 1 produces the strong/weak coupling split
    that classical AMG semi-coarsening exists for."""
    ny = ny if ny is not None else nx
    hx2 = float((nx + 1) ** 2)
    hy2 = float((ny + 1) ** 2)
    Tx = sp.diags([-hx2, 2 * hx2, -hx2], [-1, 0, 1], shape=(nx, nx))
    Ty = sp.diags([-hy2, 2 * hy2, -hy2], [-1, 0, 1], shape=(ny, ny))
    A = (sp.kron(sp.eye(ny), Tx) + eps * sp.kron(Ty, sp.eye(nx))).tocsr()
    A.eliminate_zeros()
    A.sort_indices()
    return CSRMatrix.from_scipy(A.astype(dtype))


def anisotropic_3d(nx: int, eps_y: float, eps_z: float,
                   dtype=np.float64) -> CSRMatrix:
    """-u_xx - eps_y u_yy - eps_z u_zz on the unit cube (7-point)."""
    h2 = float((nx + 1) ** 2)
    T = sp.diags([-h2, 2 * h2, -h2], [-1, 0, 1], shape=(nx, nx))
    I = sp.eye(nx)
    A = (sp.kron(I, sp.kron(I, T)) + eps_y * sp.kron(I, sp.kron(T, I))
         + eps_z * sp.kron(T, sp.kron(I, I))).tocsr()
    A.eliminate_zeros()
    A.sort_indices()
    return CSRMatrix.from_scipy(A.astype(dtype))


def jump_2d(nx: int, contrast: float, dtype=np.float64) -> CSRMatrix:
    """-div(a grad u) with a piecewise-constant coefficient: ``contrast``
    inside the centered square [1/4, 3/4]^2, 1 outside.  Finite-volume
    5-point scheme with harmonic face averaging — the standard
    jump-coefficient stress test for interpolation quality."""
    n = nx
    h = 1.0 / (n + 1)
    xc = (np.arange(n) + 1) * h
    X, Y = np.meshgrid(xc, xc, indexing="xy")
    a = np.where((X > 0.25) & (X < 0.75) & (Y > 0.25) & (Y < 0.75),
                 contrast, 1.0)              # (ny, nx) nodal coefficient

    def harm(p, q):
        return 2.0 * p * q / (p + q)

    # face transmissibilities between neighboring nodes
    tx = harm(a[:, :-1], a[:, 1:]) / h**2    # (ny, nx-1)
    ty = harm(a[:-1, :], a[1:, :]) / h**2    # (ny-1, nx)
    # boundary faces use the interior node's own coefficient
    bx_l = a[:, 0] / h**2
    bx_r = a[:, -1] / h**2
    by_b = a[0, :] / h**2
    by_t = a[-1, :] / h**2

    idx = np.arange(n * n).reshape(n, n)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(v.ravel())

    add(idx[:, :-1], idx[:, 1:], -tx)
    add(idx[:, 1:], idx[:, :-1], -tx)
    add(idx[:-1, :], idx[1:, :], -ty)
    add(idx[1:, :], idx[:-1, :], -ty)
    diag = np.zeros((n, n))
    diag[:, :-1] += tx
    diag[:, 1:] += tx
    diag[:-1, :] += ty
    diag[1:, :] += ty
    diag[:, 0] += bx_l
    diag[:, -1] += bx_r
    diag[0, :] += by_b
    diag[-1, :] += by_t
    add(idx, idx, diag)
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n * n, n * n)).tocsr()
    A.sort_indices()
    return CSRMatrix.from_scipy(A.astype(dtype))


def convdiff_2d(nx: int, vx: float, vy: float,
                dtype=np.float64) -> CSRMatrix:
    """-Delta u + (vx, vy) . grad u, first-order upwind convection —
    NONSYMMETRIC M-matrix (the gre__115/orsreg-class stress for
    BiCGstab/GMRES + nonsymmetric AMG)."""
    n = nx
    h = 1.0 / (n + 1)
    h2 = 1.0 / h**2

    def conv1d(v):
        # upwind: v>0 takes the backward difference
        lo = -max(v, 0.0) / h
        hi = min(v, 0.0) / h
        return sp.diags([lo, (max(v, 0.0) - min(v, 0.0)) / h, hi],
                        [-1, 0, 1], shape=(n, n))

    T = sp.diags([-h2, 2 * h2, -h2], [-1, 0, 1], shape=(n, n))
    I = sp.eye(n)
    A = (sp.kron(I, T) + sp.kron(T, I)
         + sp.kron(I, conv1d(vx)) + sp.kron(conv1d(vy), I)).tocsr()
    A.eliminate_zeros()
    A.sort_indices()
    return CSRMatrix.from_scipy(A.astype(dtype))


def stretched_2d(nx: int, ratio: float, dtype=np.float64) -> CSRMatrix:
    """Poisson on a geometrically stretched grid: spacings grow by a
    constant factor so h_max/h_min = ``ratio`` across the domain — the
    boundary-layer mesh case (large local aspect ratios without an
    anisotropic PDE)."""
    n = nx
    r = ratio ** (1.0 / max(n, 1))
    hs = r ** np.arange(n + 1)
    hs = hs / hs.sum()                       # spacings summing to 1

    def t1d():
        # finite-volume form (rows scaled by control volume): symmetric
        # positive definite, unlike the raw 3-point FD on a nonuniform
        # grid
        hl = hs[:-1][:n]                     # h_{i-1/2}
        hr = hs[1:][:n]                      # h_{i+1/2}
        wl = 1.0 / hl
        wr = 1.0 / hr
        return sp.diags([-wl[1:], wl + wr, -wr[:-1]], [-1, 0, 1],
                        shape=(n, n))

    T = t1d()
    I = sp.eye(n)
    A = (sp.kron(I, T) + sp.kron(T, I)).tocsr()
    A.eliminate_zeros()
    A.sort_indices()
    return CSRMatrix.from_scipy(A.astype(dtype))
