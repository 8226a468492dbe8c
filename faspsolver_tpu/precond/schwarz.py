"""Overlapping Schwarz preconditioner.

Reference: base/src/BlaSchwarzSetup.c:46 (fasp_swz_dcsr_setup): maximal-
independent-set roots -> BFS level sets to SWZ_maxlvl depth -> overlapping
blocks; per-block direct factorization; forward/backward multiplicative
sweeps (fasp_dcsr_swz_forward/backward), wrapped as a preconditioner
(fasp_precond_swz, PreCSR.c:371).

Device form: blocks are padded to a common size and their LU factors live as
one batched (nblk, m, m) array — a block solve is a single vmapped
``lu_solve`` (batched).  The reference's sequential multiplicative
sweep becomes *color-batched*: blocks are colored on their overlap graph;
within a color all solves run in one batch, colors run in sequence
(forward) or reverse (backward) — same trick as the multicolor GS smoother.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..constants import SchwarzType
from ..formats import CSRMatrix
from ..ops.operators import default_dtype, device_operator
from ..utils.params import SWZParam


def _mis_roots(adj: sp.csr_matrix) -> np.ndarray:
    """Greedy maximal independent set (reference: fasp_sparse_mis,
    BlaSparseUtil.c)."""
    n = adj.shape[0]
    state = np.zeros(n, dtype=np.int8)   # 0 undecided, 1 in MIS, -1 out
    indptr, indices = adj.indptr, adj.indices
    for i in range(n):
        if state[i] == 0:
            state[i] = 1
            state[indices[indptr[i]:indptr[i + 1]]] = \
                np.where(state[indices[indptr[i]:indptr[i + 1]]] == 0, -1,
                         state[indices[indptr[i]:indptr[i + 1]]])
    return np.nonzero(state == 1)[0]


def _bfs_block(indptr, indices, root: int, maxlvl: int, maxsize: int
               ) -> np.ndarray:
    seen = {int(root)}
    frontier = [int(root)]
    for _ in range(maxlvl):
        nxt = []
        for u in frontier:
            for v in indices[indptr[u]:indptr[u + 1]]:
                v = int(v)
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
                    if len(seen) >= maxsize:
                        return np.array(sorted(seen))
        frontier = nxt
        if not frontier:
            break
    return np.array(sorted(seen))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _ColorGroup:
    dofs: jax.Array       # (nb, m) int32 dof ids, padded with n (ghost)
    mask: jax.Array       # (nb, m) 1.0 valid / 0.0 padding
    inv: jax.Array        # (nb, m, m) block inverses (host-factorized)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SchwarzPrecond:
    """Color-batched overlapping Schwarz (SWZ_data analog, fasp.h:726-796)."""

    groups: Tuple[_ColorGroup, ...]
    A: object                             # device operator for residual upds
    n: int = dataclasses.field(metadata=dict(static=True))
    swz_type: int = dataclasses.field(metadata=dict(static=True),
                                      default=int(SchwarzType.FORWARD))

    def _sweep(self, x, r, order):
        for gi in order:
            g = self.groups[gi]
            # gather current residual on each block (ghost index n -> 0)
            rloc = jnp.where(g.mask > 0, r[jnp.minimum(g.dofs, self.n - 1)],
                             0.0)
            # batched dense block solve via precomputed inverses: one
            # (nb,m,m)x(nb,m) batched contraction
            e = jnp.einsum("bij,bj->bi", g.inv, rloc,
                           precision=jax.lax.Precision.HIGHEST) * g.mask
            dx = jnp.zeros_like(x).at[g.dofs.reshape(-1)].add(
                e.reshape(-1), mode="drop")
            x = x + dx
            r = r - self.A(dx)
        return x, r

    def __call__(self, r0: jax.Array) -> jax.Array:
        x = jnp.zeros_like(r0)
        r = r0
        fwd = range(len(self.groups))
        bwd = range(len(self.groups) - 1, -1, -1)
        if self.swz_type == SchwarzType.BACKWARD:
            x, r = self._sweep(x, r, bwd)
        elif self.swz_type == SchwarzType.SYMMETRIC:
            x, r = self._sweep(x, r, fwd)
            x, r = self._sweep(x, r, bwd)
        else:
            x, r = self._sweep(x, r, fwd)
        return x


def setup_schwarz(A: CSRMatrix, param: SWZParam = None, dtype=None
                  ) -> SchwarzPrecond:
    param = param or SWZParam()
    dtype = dtype or default_dtype()
    n = A.nrow
    m = A.to_scipy().tocsr()
    adj = m.copy()
    adj.setdiag(0)
    adj.eliminate_zeros()

    roots = _mis_roots(adj)
    blocks = [
        _bfs_block(adj.indptr, adj.indices, r, param.SWZ_maxlvl,
                   param.SWZ_mmsize)
        for r in roots
    ]
    # every dof must appear in at least one block; add singletons for missed
    covered = np.zeros(n, dtype=bool)
    for blk in blocks:
        covered[blk] = True
    for i in np.nonzero(~covered)[0]:
        blocks.append(np.array([i]))

    # color blocks on their overlap graph (shared dof => conflict)
    owner: dict = {}
    conflicts = [set() for _ in blocks]
    for bi, blk in enumerate(blocks):
        for d in blk:
            if d in owner:
                for o in owner[d]:
                    conflicts[bi].add(o)
                    conflicts[o].add(bi)
                owner[d].append(bi)
            else:
                owner[d] = [bi]
    colors = np.full(len(blocks), -1, dtype=np.int64)
    for bi in range(len(blocks)):
        used = {colors[o] for o in conflicts[bi]}
        c = 0
        while c in used:
            c += 1
        colors[bi] = c

    msize = max(len(b) for b in blocks)
    groups: List[_ColorGroup] = []
    for c in range(int(colors.max()) + 1):
        idx = np.nonzero(colors == c)[0]
        nb = len(idx)
        dofs = np.full((nb, msize), n, dtype=np.int32)
        mask = np.zeros((nb, msize), dtype=np.dtype(dtype))
        mats = np.tile(np.eye(msize, dtype=np.dtype(dtype)), (nb, 1, 1))
        for k, bi in enumerate(idx):
            blk = blocks[bi]
            sz = len(blk)
            dofs[k, :sz] = blk
            mask[k, :sz] = 1.0
            sub = m[blk, :][:, blk].toarray()
            mats[k, :sz, :sz] = sub
        # per-block direct factorization on host at setup (reference
        # factorizes with UMFPACK/dense LU, BlaSchwarzSetup.c); the device
        # keeps only the inverses for the batched-matmul apply
        inv = np.linalg.inv(mats.astype(np.float64)).astype(np.dtype(dtype))
        groups.append(_ColorGroup(dofs=jnp.asarray(dofs),
                                  mask=jnp.asarray(mask),
                                  inv=jnp.asarray(inv)))

    return SchwarzPrecond(groups=tuple(groups),
                          A=device_operator(A, dtype=dtype), n=n,
                          swz_type=param.SWZ_type)
