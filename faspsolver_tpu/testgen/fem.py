"""P1 finite-element mini-library: meshes, assembly, manufactured problems.

Reference: the libfasptest FEM generator — test/src/FemMesh.c (uniform
refinement), FemQuadrature.c (triangle quadrature rules), FemPoisson.c
(setup_poisson P1 assembly + get_l2_error_poisson), FemHeatEqn.c
(setup_heat, backward-Euler heat equation), FemAssemble.c (Dirichlet
elimination).  Produces exact-solution test systems so solvers can be
checked end-to-end, like regression problem 2 (csrmat_FE corpus).

Everything is vectorized NumPy — assembly is a setup/test-path concern,
not a device kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import scipy.sparse as sp

from ..formats import CSRMatrix


# ---------------------------------------------------------------------------
# mesh (reference: FemMesh.c)
# ---------------------------------------------------------------------------

@dataclass
class TriMesh:
    nodes: np.ndarray          # (nn, 2)
    elems: np.ndarray          # (ne, 3) int
    boundary: np.ndarray       # (nn,) bool — Dirichlet nodes

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_elems(self) -> int:
        return len(self.elems)


def unit_square_mesh(n: int) -> TriMesh:
    """Uniform criss-cross triangulation of the unit square with (n+1)^2
    nodes (reference mesh.dat topology)."""
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs)
    nodes = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)

    def nid(i, j):
        return i * (n + 1) + j

    elems = []
    for i in range(n):
        for j in range(n):
            a, b = nid(i, j), nid(i, j + 1)
            c, d = nid(i + 1, j), nid(i + 1, j + 1)
            elems.append((a, b, d))
            elems.append((a, d, c))
    elems = np.asarray(elems, dtype=np.int64)
    onb = ((nodes[:, 0] == 0) | (nodes[:, 0] == 1)
           | (nodes[:, 1] == 0) | (nodes[:, 1] == 1))
    return TriMesh(nodes=nodes, elems=elems, boundary=onb)


def refine_uniform(mesh: TriMesh) -> TriMesh:
    """One uniform (red) refinement: each triangle into 4
    (reference: fasp_mesh_refine, FemMesh.c)."""
    nodes = mesh.nodes
    elems = mesh.elems
    edge_mid = {}
    new_nodes = [nodes]
    next_id = len(nodes)

    def mid(a, b):
        nonlocal next_id
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            edge_mid[key] = next_id
            new_nodes.append(((nodes[a] + nodes[b]) / 2.0)[None, :])
            next_id += 1
        return edge_mid[key]

    new_elems = []
    for a, b, c in elems:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        new_elems += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
    nn = np.concatenate(new_nodes)
    onb = ((nn[:, 0] == 0) | (nn[:, 0] == 1)
           | (nn[:, 1] == 0) | (nn[:, 1] == 1))
    return TriMesh(nodes=nn, elems=np.asarray(new_elems, dtype=np.int64),
                   boundary=onb)


# ---------------------------------------------------------------------------
# quadrature (reference: FemQuadrature.c)
# ---------------------------------------------------------------------------

_QUAD_RULES = {
    1: (np.array([[1 / 3, 1 / 3, 1 / 3]]), np.array([1.0])),
    3: (np.array([[2 / 3, 1 / 6, 1 / 6],
                  [1 / 6, 2 / 3, 1 / 6],
                  [1 / 6, 1 / 6, 2 / 3]]), np.full(3, 1 / 3)),
    7: (np.array([[1 / 3, 1 / 3, 1 / 3],
                  [0.797426985353087, 0.101286507323456, 0.101286507323456],
                  [0.101286507323456, 0.797426985353087, 0.101286507323456],
                  [0.101286507323456, 0.101286507323456, 0.797426985353087],
                  [0.059715871789770, 0.470142064105115, 0.470142064105115],
                  [0.470142064105115, 0.059715871789770, 0.470142064105115],
                  [0.470142064105115, 0.470142064105115, 0.059715871789770]]),
        np.array([0.225,
                  0.125939180544827, 0.125939180544827, 0.125939180544827,
                  0.132394152788506, 0.132394152788506, 0.132394152788506])),
}


def quad_points(order: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Barycentric quadrature points + weights on the reference triangle."""
    for npts in (1, 3, 7):
        if npts >= order:
            return _QUAD_RULES[npts]
    return _QUAD_RULES[7]


# ---------------------------------------------------------------------------
# P1 assembly (reference: FemPoisson.c setup_poisson + FemAssemble.c)
# ---------------------------------------------------------------------------

def _p1_geometry(mesh: TriMesh):
    p = mesh.nodes[mesh.elems]                   # (ne, 3, 2)
    v0, v1, v2 = p[:, 0], p[:, 1], p[:, 2]
    J = np.stack([v1 - v0, v2 - v0], axis=2)     # (ne, 2, 2) columns
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    area = np.abs(detJ) / 2.0
    # gradients of barycentric basis (J^{-T} columns): grad lambda_i
    g = np.empty((len(p), 3, 2))
    g[:, 1, 0] = J[:, 1, 1]          # (y2-y0)/det
    g[:, 1, 1] = -J[:, 0, 1]         # -(x2-x0)/det
    g[:, 2, 0] = -J[:, 1, 0]         # -(y1-y0)/det
    g[:, 2, 1] = J[:, 0, 0]          # (x1-x0)/det
    g[:, 1:, :] /= detJ[:, None, None]
    g[:, 0] = -(g[:, 1] + g[:, 2])
    return area, g


def assemble_poisson(mesh: TriMesh,
                     f: Callable[[np.ndarray], np.ndarray],
                     u_exact: Callable[[np.ndarray], np.ndarray] = None,
                     quad_order: int = 3
                     ) -> Tuple[CSRMatrix, np.ndarray, np.ndarray]:
    """Assemble -Δu = f with homogeneous (or manufactured) Dirichlet BCs.

    Returns (A, b, dof_map): A is the interior-node stiffness matrix after
    Dirichlet elimination (reference: fasp_assemble + elimination,
    FemAssemble.c), b the load, dof_map the interior node ids.
    """
    area, g = _p1_geometry(mesh)
    ne = mesh.num_elems
    nn = mesh.num_nodes
    # local stiffness: area * grad_i . grad_j  -> (ne, 3, 3)
    K = np.einsum("eid,ejd->eij", g, g) * area[:, None, None]
    rows = np.repeat(mesh.elems, 3, axis=1).reshape(-1)
    cols = np.tile(mesh.elems, (1, 3)).reshape(-1)
    Afull = sp.coo_matrix((K.reshape(-1), (rows, cols)),
                          shape=(nn, nn)).tocsr()
    # load vector by quadrature
    lam, w = quad_points(quad_order)
    b = np.zeros(nn)
    pts = mesh.nodes[mesh.elems]                 # (ne, 3, 2)
    for lk, wk in zip(lam, w):
        x = np.einsum("k,ekd->ed", lk, pts)      # quad point per element
        fv = f(x)
        for i in range(3):
            np.add.at(b, mesh.elems[:, i], wk * area * fv * lk[i])

    interior = np.nonzero(~mesh.boundary)[0]
    if u_exact is not None:
        ub = np.zeros(nn)
        ub[mesh.boundary] = u_exact(mesh.nodes[mesh.boundary])
        b = b - Afull @ ub
    Ai = Afull[interior][:, interior].tocsr()
    return CSRMatrix.from_scipy(Ai), b[interior], interior


def l2_error(mesh: TriMesh, u_h: np.ndarray, interior: np.ndarray,
             u_exact: Callable[[np.ndarray], np.ndarray],
             quad_order: int = 3) -> float:
    """||u_h - u||_L2 over the mesh (reference: get_l2_error_poisson,
    FemPoisson.c).  u_h holds interior values; boundary filled from the
    exact solution."""
    nn = mesh.num_nodes
    u = np.zeros(nn)
    u[interior] = u_h
    bmask = mesh.boundary
    u[bmask] = u_exact(mesh.nodes[bmask])
    area, _ = _p1_geometry(mesh)
    lam, w = quad_points(quad_order)
    pts = mesh.nodes[mesh.elems]
    ue = u[mesh.elems]                           # (ne, 3)
    err2 = 0.0
    for lk, wk in zip(lam, w):
        x = np.einsum("k,ekd->ed", lk, pts)
        uh_q = ue @ lk
        err2 += float(np.sum(wk * area * (uh_q - u_exact(x)) ** 2))
    return float(np.sqrt(err2))


def poisson_fe_manufactured(n: int
                            ) -> Tuple[CSRMatrix, np.ndarray, TriMesh,
                                       np.ndarray, Callable]:
    """P1 FE Poisson with u = sin(pi x) sin(pi y) (the tutorial problem);
    returns (A, b, mesh, interior, u_exact)."""
    mesh = unit_square_mesh(n)

    def u_exact(x):
        return np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])

    def f(x):
        return 2 * np.pi ** 2 * np.sin(np.pi * x[:, 0]) \
            * np.sin(np.pi * x[:, 1])

    A, b, interior = assemble_poisson(mesh, f, u_exact)
    return A, b, mesh, interior, u_exact


# ---------------------------------------------------------------------------
# heat equation (reference: FemHeatEqn.c setup_heat)
# ---------------------------------------------------------------------------

def assemble_mass(mesh: TriMesh) -> sp.csr_matrix:
    """P1 consistent mass matrix."""
    area, _ = _p1_geometry(mesh)
    Mloc = (np.ones((3, 3)) + np.eye(3)) / 12.0    # int lambda_i lambda_j
    M = np.einsum("e,ij->eij", area, Mloc)
    rows = np.repeat(mesh.elems, 3, axis=1).reshape(-1)
    cols = np.tile(mesh.elems, (1, 3)).reshape(-1)
    nn = mesh.num_nodes
    return sp.coo_matrix((M.reshape(-1), (rows, cols)),
                         shape=(nn, nn)).tocsr()


def heat_backward_euler_system(mesh: TriMesh, dt: float
                               ) -> Tuple[CSRMatrix, sp.csr_matrix,
                                          np.ndarray]:
    """(M + dt K) for backward-Euler heat stepping on interior nodes
    (reference: setup_heat, FemHeatEqn.c builds the same per-step system).
    Returns (system, interior mass, interior ids)."""
    area, g = _p1_geometry(mesh)
    nn = mesh.num_nodes
    K = np.einsum("eid,ejd->eij", g, g) * area[:, None, None]
    rows = np.repeat(mesh.elems, 3, axis=1).reshape(-1)
    cols = np.tile(mesh.elems, (1, 3)).reshape(-1)
    Kfull = sp.coo_matrix((K.reshape(-1), (rows, cols)),
                          shape=(nn, nn)).tocsr()
    Mfull = assemble_mass(mesh)
    interior = np.nonzero(~mesh.boundary)[0]
    Ai = (Mfull + dt * Kfull)[interior][:, interior].tocsr()
    Mi = Mfull[interior][:, interior].tocsr()
    return CSRMatrix.from_scipy(Ai), Mi, interior
