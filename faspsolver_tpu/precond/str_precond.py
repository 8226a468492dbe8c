"""Structured-grid (STR) preconditioners and smoothers.

Reference: base/src/PreSTR.c (fasp_precond_dstr_diag :49, _ilu0/_ilu1,
_blockgs) and ItrSmootherSTR.c (fasp_smoother_dstr_jacobi/gs/sor +
fasp_generate_diaginv_block).

Device choices:
- block-diagonal preconditioner: one batched (ng, nc, nc)x(ng, nc)
  contraction with precomputed block inverses;
- block Gauss-Seidel: the reference sweeps grid points sequentially; here
  the sweep is red-black over the grid parity (exact GS ordering for
  bipartite stencils — the 5/7-point structured case this format exists
  for), each color a masked batched update;
- ILU(0)/ILU(1): factorized natively IN BAND SPACE (banded-block
  wavefront elimination — A is never expanded to CSR), applied via the
  batched BLOCK level-scheduled solves (the reference's dstr ILU is a
  banded-block factorization too, BlaILUSetupSTR.c:1282).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.str_grid import STRMatrix
from ..ops.operators import default_dtype
from ..ops.str_ops import StrOperator


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class StrDiagPrecond:
    """z = blockdiag(A)^{-1} r (reference: fasp_precond_dstr_diag,
    PreSTR.c:49)."""

    dinv: jax.Array          # (ng, nc, nc)
    ng: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))

    def __call__(self, r: jax.Array) -> jax.Array:
        rb = r.reshape(self.ng, self.nc)
        return jnp.einsum("gab,gb->ga", self.dinv, rb,
                          precision=jax.lax.Precision.HIGHEST).reshape(-1)


def _grid_parity(A: STRMatrix) -> np.ndarray:
    z, y, x = np.meshgrid(np.arange(A.nz), np.arange(A.ny),
                          np.arange(A.nx), indexing="ij")
    return ((x + y + z) % 2).reshape(-1)


def _bipartite(A: STRMatrix) -> bool:
    """Stencil offsets all flip grid parity -> red-black GS is exact."""
    dims = (A.nz, A.ny, A.nx)
    for off in A.offsets:
        o, parity = abs(int(off)), 0
        for s in (A.nx * A.ny, A.nx, 1):
            c = int(np.rint(o / s)) if s > 1 else o
            parity += c
            o -= c * s
        if (parity + o) % 2 == 0:
            return False
    return True


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class StrBlockGSPrecond:
    """Block Gauss-Seidel sweeps (reference: fasp_precond_dstr_blockgs,
    PreSTR.c; ItrSmootherSTR fasp_smoother_dstr_gs).  Red-black masked when
    the stencil is bipartite; damped block-Jacobi otherwise (documented
    deviation — sequential grid sweeps have no gather-free parallel form)."""

    A: StrOperator
    dinv: jax.Array                 # (ng, nc, nc)
    masks: Tuple[jax.Array, ...]    # per color: (ng,) 0/1
    nsweeps: int = dataclasses.field(metadata=dict(static=True), default=2)

    def _sweep(self, x, b, mask):
        r = b - self.A(x)
        rb = r.reshape(self.A.ng, self.A.nc)
        upd = jnp.einsum("gab,gb->ga", self.dinv, rb,
                         precision=jax.lax.Precision.HIGHEST)
        return x + (mask[:, None] * upd).reshape(-1)

    def __call__(self, r: jax.Array) -> jax.Array:
        x = jnp.zeros_like(r)
        for _ in range(self.nsweeps):
            for m in self.masks:
                x = self._sweep(x, r, m)
        return x


def setup_str_diag(A: STRMatrix, dtype=None) -> StrDiagPrecond:
    dtype = dtype or default_dtype()
    dinv = np.linalg.inv(A.diag.astype(np.float64))
    return StrDiagPrecond(jnp.asarray(dinv.astype(np.dtype(dtype))),
                          A.ngrid, A.nc)


def setup_str_blockgs(A: STRMatrix, nsweeps: int = 2, dtype=None
                      ) -> StrBlockGSPrecond:
    dtype = dtype or default_dtype()
    nd = np.dtype(dtype)
    op = StrOperator.from_str(A, dtype=dtype)
    dinv = np.linalg.inv(A.diag.astype(np.float64)).astype(nd)
    if _bipartite(A):
        parity = _grid_parity(A).astype(nd)
        masks = (jnp.asarray(1.0 - parity), jnp.asarray(parity))
    else:
        # damped Jacobi fallback: single full mask with 2/3 damping
        masks = (jnp.asarray(np.full(A.ngrid, 2.0 / 3.0, dtype=nd)),)
    return StrBlockGSPrecond(A=op, dinv=jnp.asarray(dinv), masks=masks,
                             nsweeps=nsweeps)


def _band_ilu_pattern(offsets: Tuple[int, ...], fill: int
                      ) -> Tuple[Tuple[int, ...], dict]:
    """Symbolic ILU(k) on the band-offset set: fill offset o1+o2 (o1 a
    lower offset, o2 any nonzero offset of the eliminated row) enters at
    level lvl(o1)+lvl(o2)+1, kept while <= fill (level-of-fill on the
    Toeplitz pattern graph; boundaries are handled numerically by range
    masks, not symbolically)."""
    lvl = {int(o): 0 for o in offsets}
    lvl[0] = 0
    for _ in range(max(fill, 0)):
        new = {}
        for o1, l1 in lvl.items():
            if o1 >= 0:
                continue
            for o2, l2 in lvl.items():
                if o2 <= 0:
                    continue     # fill comes via the pivot row's U part
                s = o1 + o2
                lv = l1 + l2 + 1
                if s != 0 and s not in lvl and lv <= fill:
                    new[s] = min(lv, new.get(s, lv))
        if not new:
            break
        lvl.update(new)
    offs = tuple(sorted(o for o in lvl if o != 0))
    return offs, lvl


def _grid_wavefronts(ng: int, offsets, forward: bool = True
                     ) -> List[np.ndarray]:
    """Dependency levels of the banded triangular graph: node g depends
    on g+o for the given offsets (o<0 forward-substitution, o>0 back-
    substitution) — the topological schedule the CSR TriangularSolver
    computes, derived straight from the offsets (longest path)."""
    lvl = np.zeros(ng, dtype=np.int64)
    deps = [int(o) for o in offsets if (o < 0 if forward else o > 0)]
    order_g = range(ng) if forward else range(ng - 1, -1, -1)
    for g in order_g:
        m = 0
        for o in deps:
            h = g + o
            if 0 <= h < ng:
                v = lvl[h] + 1
                if v > m:
                    m = v
        lvl[g] = m
    order = np.argsort(lvl, kind="stable")
    bounds = np.searchsorted(lvl[order], np.arange(lvl.max() + 2))
    return [order[bounds[i]:bounds[i + 1]]
            for i in range(len(bounds) - 1) if bounds[i] < bounds[i + 1]]


def str_ilu_factor_banded(A: STRMatrix, fill: int = 0):
    """Banded-BLOCK ILU(0)/ILU(1) factorization IN BAND SPACE
    (reference: fasp_ilu_dstr_setup0/setup1, BlaILUSetupSTR.c:1282 — the
    reference also factorizes on the dSTR bands with nc x nc blocks).

    The grid loop is vectorized by wavefront: all points on a dependency
    level factor as ONE batched nc-block elimination (einsum + batched
    inverse), so setup is O(levels) NumPy calls instead of an ng-long
    Python loop.  Returns ({offset: (ng, nc, nc) band}, offsets) for the
    unified LU storage (L unit-lower at negative offsets, U at >= 0).
    """
    ng, nc = A.ngrid, A.nc
    offs, _ = _band_ilu_pattern(A.offsets, fill)
    bands = {}
    f64 = np.float64
    for o in offs:
        bands[o] = np.zeros((ng, nc, nc), dtype=f64)
    bands[0] = A.diag.astype(f64).copy()
    for o, band in zip(A.offsets, A.offdiag):
        bands[int(o)][:] = band.astype(f64)
    neg = sorted(o for o in offs if o < 0)
    all_offs = sorted(list(offs) + [0])

    for rows in _grid_wavefronts(ng, neg):
        # eliminate columns k = g + o in increasing k order (IKJ); rows
        # within a wavefront only read earlier-level U rows, so each
        # step is one batched block op over the wavefront
        for o in neg:                       # most negative first = k asc
            g = rows[rows + o >= 0]
            if g.size == 0:
                continue
            k = g + o
            dk = bands[0][k]
            # L entry: a[g,k] <- a[g,k] @ inv(U[k,k])
            lk = np.einsum("gab,gbc->gac", bands[o][g], np.linalg.inv(dk))
            bands[o][g] = lk
            # update the remainder of row g on the kept pattern with the
            # U part of the pivot row (columns k+o2 > k only)
            for o2 in all_offs:
                if o2 <= 0:
                    continue
                t = o + o2                  # target offset in row g
                if t not in bands and t != 0:
                    continue                # dropped fill
                gg = g[(k + o2 >= 0) & (k + o2 < ng)]
                if gg.size == 0:
                    continue
                kk = gg + o
                upd = np.einsum("gab,gbc->gac", bands[o][gg],
                                bands[o2][kk])
                if t == 0:
                    bands[0][gg] -= upd
                else:
                    sel = (gg + t >= 0) & (gg + t < ng)
                    if sel.any():
                        bands[t][gg[sel]] -= upd[sel]
    return bands, tuple(all_offs)


def _banded_block_solver(bands: dict, offs, ng: int, nc: int,
                         lower: bool, dtype):
    """Pack one triangle of the factored bands into batched block levels
    for the existing :class:`~.ilu.BlockTriangularSolver` — straight from
    band space, no sparse-matrix intermediary."""
    from .ilu import BlockTriangularSolver, _BTriLevel
    np_dtype = np.dtype(dtype)
    tri = sorted(o for o in offs if (o < 0 if lower else o > 0))
    dinv_full = (np.linalg.inv(bands[0]) if not lower else None)
    eye = np.eye(nc, dtype=np_dtype)
    levels = []
    for rows in _grid_wavefronts(ng, tri, forward=lower):
        m = len(rows)
        k = max(len(tri), 1)
        cols = np.full((m, k), ng, dtype=np.int32)
        blks = np.zeros((m, k, nc, nc), dtype=np_dtype)
        for s, o in enumerate(tri):
            h = rows + o
            ok = (h >= 0) & (h < ng)
            cols[ok, s] = h[ok]
            blks[ok, s] = bands[o][rows[ok]]
        di = (dinv_full[rows].astype(np_dtype) if not lower
              else np.broadcast_to(eye, (m, nc, nc)).copy())
        levels.append(_BTriLevel(
            rows=jnp.asarray(rows.astype(np.int32)),
            cols=jnp.asarray(cols), vals=jnp.asarray(blks),
            dinv=jnp.asarray(di)))
    return BlockTriangularSolver(levels=tuple(levels), n=ng)


def setup_str_ilu(A: STRMatrix, fill: int = 0, dtype=None):
    """STR ILU(0)/ILU(1) (reference: fasp_ilu_dstr_setup0/1,
    BlaILUSetupSTR.c:1282; applier fasp_precond_dstr_ilu0/1, PreSTR.c).

    Factorized natively in band space (banded-block wavefront
    elimination, :func:`str_ilu_factor_banded` — A is never expanded to
    CSR) and applied with the existing batched BLOCK level-scheduled
    solves.  ``fill >= 2`` falls back to the CSR ILU(k) machinery (the
    reference's dstr setups only exist for 0/1 either)."""
    from .ilu import BSRILUPrecond
    dtype = dtype or default_dtype()
    if fill >= 2:
        from .ilu import setup_ilu
        from ..utils.params import ILUParam
        from ..constants import ILUType
        return setup_ilu(A.to_csr(),
                         ILUParam(ILU_type=int(ILUType.ILUK),
                                  ILU_lfil=fill), dtype=dtype)
    bands, offs = str_ilu_factor_banded(A, fill)
    return BSRILUPrecond(
        Lsolve=_banded_block_solver(bands, offs, A.ngrid, A.nc, True,
                                    dtype),
        Usolve=_banded_block_solver(bands, offs, A.ngrid, A.nc, False,
                                    dtype),
        nb=A.nc)


# ---------------------------------------------------------------------------
# Schwarz smoother on the structured grid
# (reference: fasp_smoother_dstr_swz + fasp_generate_diaginv_block,
#  ItrSmootherSTR.c:1665/1565 — per grid node, solve the overlapping
#  {node + stencil neighbours} patch exactly and add the correction)
# ---------------------------------------------------------------------------

def _linear_to_coords(d: int, nx: int, ny: int) -> Tuple[int, int, int]:
    """Decompose a linear grid offset into (dx, dy, dz) for the standard
    STR offset convention (+-1, +-nx, +-nx*ny and combinations)."""
    nxy = nx * ny
    dz = int(np.rint(d / nxy)) if nxy > 1 else 0
    rem = d - dz * nxy
    dy = int(np.rint(rem / nx)) if nx > 1 else 0
    dx = rem - dy * nx
    return dx, dy, dz


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class StrSchwarzSmoother:
    """Schwarz-as-smoother (reference: fasp_smoother_dstr_swz,
    ItrSmootherSTR.c:1665): for each grid node, gather the residual on
    the overlapping patch {node} + stencil neighbours, solve the dense
    patch system with a precomputed factorization, and add the
    correction to the node and its neighbours.

    Device form: nodes are COLOR-BATCHED so that patches within one
    color are disjoint — each color is one batched dense (m, m) solve,
    with the residual refreshed between colors.  This is the
    same multiplicative-across / additive-within-color semantics as the
    multicolor GS family (documented deviation: the reference refreshes
    the residual after EVERY node; with singleton colors the two
    coincide exactly).
    """

    A: StrOperator
    inv: jax.Array        # (ng, m, m) patch inverses (pinv at boundary)
    members: jax.Array    # (ng, k1) int32 patch grid nodes (pad -> ng)
    valid: jax.Array      # (ng, k1) float mask of real members
    colors: Tuple[jax.Array, ...]   # node-id arrays, one per color
    nsweeps: int = dataclasses.field(metadata=dict(static=True), default=1)

    def _color_update(self, x, b, nodes):
        ng, nc = self.A.ng, self.A.nc
        r = (b - self.A(x)).reshape(ng, nc)
        mem = self.members[nodes]               # (q, k1)
        val = self.valid[nodes]                 # (q, k1)
        ri = r[jnp.clip(mem, 0, ng - 1)] * val[:, :, None]   # (q, k1, nc)
        q, k1 = mem.shape
        e = jnp.einsum("qab,qb->qa", self.inv[nodes],
                       ri.reshape(q, k1 * nc),  # (q, m)
                       precision=jax.lax.Precision.HIGHEST)
        e = (e.reshape(q, k1, nc) * val[:, :, None]).reshape(-1, nc)
        xb = x.reshape(ng, nc)
        flat = jnp.where(val.reshape(-1) > 0, mem.reshape(-1), ng)
        xb = jnp.concatenate([xb, jnp.zeros((1, nc), xb.dtype)])
        xb = xb.at[flat].add(e)
        return xb[:ng].reshape(-1)

    def __call__(self, r: jax.Array) -> jax.Array:
        x = jnp.zeros_like(r)
        for _ in range(self.nsweeps):
            for nodes in self.colors:
                x = self._color_update(x, r, nodes)
        return x

    def smooth(self, x, b, nsweeps: int):
        for _ in range(nsweeps):
            for nodes in self.colors:
                x = self._color_update(x, b, nodes)
        return x


def setup_str_schwarz(A: STRMatrix, dtype=None,
                      nsweeps: int = 1) -> StrSchwarzSmoother:
    """Build the patch factorizations + conflict-free node coloring for
    :class:`StrSchwarzSmoother` (reference setup:
    fasp_generate_diaginv_block, ItrSmootherSTR.c:1565 — LU of each
    (node + neighbours) patch)."""
    dtype = dtype or default_dtype()
    ng, nc = A.ngrid, A.nc
    offs = [0] + [int(o) for o in A.offsets]
    k1 = len(offs)
    m = k1 * nc
    g = np.arange(ng, dtype=np.int64)
    members = np.stack([g + o for o in offs], axis=1)        # (ng, k1)
    valid = (members >= 0) & (members < ng)
    # row-boundary validity: an x-offset must not wrap across grid rows
    for s, o in enumerate(offs):
        dx, dy, dz = _linear_to_coords(o, A.nx, A.ny)
        gx = g % A.nx
        gy = (g // A.nx) % A.ny
        ok = (gx + dx >= 0) & (gx + dx < A.nx) \
            & (gy + dy >= 0) & (gy + dy < A.ny)
        valid[:, s] &= ok
    members = np.where(valid, members, ng).astype(np.int32)

    # patch matrices: blocks between patch members (offset differences
    # that are themselves stencil offsets)
    off_idx = {int(o): i for i, o in enumerate(A.offsets)}
    P = np.zeros((ng, m, m), dtype=np.float64)
    for a in range(k1):
        ga = g + offs[a]
        va = valid[:, a]
        for b_ in range(k1):
            d = offs[b_] - offs[a]
            vb = valid[:, b_] & va
            sl = np.s_[a * nc:(a + 1) * nc, b_ * nc:(b_ + 1) * nc]
            if d == 0:
                blocks = A.diag[np.clip(ga, 0, ng - 1)]
            elif d in off_idx:
                blocks = A.offdiag[off_idx[d]][np.clip(ga, 0, ng - 1)]
            else:
                continue
            P[:, sl[0], sl[1]] = np.where(vb[:, None, None], blocks, 0.0)
    # identity rows for invalid slots keep the batch invertible
    for a in range(k1):
        bad = ~valid[:, a]
        if bad.any():
            for j in range(nc):
                P[bad, a * nc + j, :] = 0.0
                P[bad, a * nc + j, a * nc + j] = 1.0
    inv = np.linalg.inv(P)

    # conflict-free coloring: patches of g and h intersect iff h - g is a
    # difference of two patch offsets; color on grid coordinates modulo
    # (2*max|dx|+1, ...) per axis
    coords = [(_linear_to_coords(o, A.nx, A.ny)) for o in offs]
    mx = max(abs(ca[0] - cb[0]) for ca in coords for cb in coords)
    my = max(abs(ca[1] - cb[1]) for ca in coords for cb in coords)
    mz = max(abs(ca[2] - cb[2]) for ca in coords for cb in coords)
    cx, cy, cz = (min(mx + 1, A.nx), min(my + 1, max(A.ny, 1)),
                  min(mz + 1, max(A.nz, 1)))
    gx = g % A.nx
    gy = (g // A.nx) % max(A.ny, 1)
    gz = g // (A.nx * max(A.ny, 1))
    color = (gx % cx) + cx * ((gy % cy) + cy * (gz % cz))
    ncolors = cx * cy * cz
    colors = tuple(jnp.asarray(np.flatnonzero(color == c).astype(np.int32))
                   for c in range(ncolors)
                   if np.any(color == c))

    dt = np.dtype(dtype)
    return StrSchwarzSmoother(
        A=StrOperator.from_str(A, dtype=dt),
        inv=jnp.asarray(inv.astype(dt)),
        members=jnp.asarray(members),
        valid=jnp.asarray(valid.astype(dt)),
        colors=colors, nsweeps=nsweeps)
