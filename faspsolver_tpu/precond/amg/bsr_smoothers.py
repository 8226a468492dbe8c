"""Block (BSR) smoothers: block Jacobi and color-batched block Gauss-Seidel.

Reference: base/src/ItrSmootherBSR.c (fasp_smoother_dbsr_jacobi,
gs_ascend/descend using precomputed diaginv block inverses,
BlaSparseBSR.c fasp_dbsr_getdiaginv).

Device form: each color's block rows are pre-gathered; a sweep is a batched
(nb,nb)x(nb,) contraction per color — the block analog of the scalar
multicolor GS in smoothers.py.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import SmootherType
from ...formats import BSRMatrix


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BsrColorBlock:
    rows: jax.Array     # (nc,) int32 block-row ids
    cols: jax.Array     # (nc, k) int32 block-col ids (off-diagonal blocks)
    vals: jax.Array     # (nc, k, nb, nb)
    dinv: jax.Array     # (nc, nb, nb) inverse diagonal blocks


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BsrSmootherData:
    kind: int = dataclasses.field(metadata=dict(static=True))
    relax: float = dataclasses.field(metadata=dict(static=True))
    nb: int = dataclasses.field(metadata=dict(static=True))
    dinv: jax.Array = None                      # (nbrow, nb, nb)
    colors: Tuple[BsrColorBlock, ...] = ()


def build_bsr_smoother(A: BSRMatrix, kind: int, *, relax: float = 1.0,
                       dtype=None) -> BsrSmootherData:
    from ...ops.operators import default_dtype
    dtype = dtype or default_dtype()
    nb = A.nb
    dinv = A.diag_inv().astype(np.dtype(dtype))
    kind = int(kind)

    if kind in (SmootherType.JACOBI, SmootherType.JACOBIF,
                SmootherType.L1DIAG):
        return BsrSmootherData(kind=int(SmootherType.JACOBI),
                               relax=float(relax), nb=nb,
                               dinv=jnp.asarray(dinv))

    # GS family: multicolor on the block graph
    colors, counts = A.condense(norm_type=1).multicolor()
    indptr, indices, data = A.indptr, A.indices, A.data
    blocks = []
    for c in range(len(counts)):
        rows = np.nonzero(colors == c)[0]
        nnz_per = np.array([indptr[r + 1] - indptr[r] for r in rows])
        k = max(int(nnz_per.max()) if len(rows) else 0, 1)
        cols = np.zeros((len(rows), k), dtype=np.int32)
        vals = np.zeros((len(rows), k, nb, nb), dtype=np.dtype(dtype))
        for i, r in enumerate(rows):
            s, e = indptr[r], indptr[r + 1]
            slot = 0
            for jj in range(s, e):
                j = indices[jj]
                if j == r:
                    continue                      # diagonal excluded
                cols[i, slot] = j
                vals[i, slot] = data[jj]
                slot += 1
        blocks.append(BsrColorBlock(
            rows=jnp.asarray(rows.astype(np.int32)),
            cols=jnp.asarray(cols), vals=jnp.asarray(vals),
            dinv=jnp.asarray(dinv[rows])))
    return BsrSmootherData(kind=kind, relax=float(relax), nb=nb,
                           dinv=jnp.asarray(dinv), colors=tuple(blocks))


def bsr_color_sweep(sm: BsrSmootherData, x, b, order):
    nb = sm.nb
    xb = x.reshape(-1, nb)
    bb = b.reshape(-1, nb)
    for ci in order:
        blk = sm.colors[ci]
        # off-block contribution: (nc, k, nb, nb) x (nc, k, nb) -> (nc, nb)
        gathered = xb[blk.cols]
        off = jnp.einsum("rkab,rkb->ra", blk.vals, gathered,
                         precision=jax.lax.Precision.HIGHEST)
        rhs = bb[blk.rows] - off
        xn = jnp.einsum("rab,rb->ra", blk.dinv, rhs,
                        precision=jax.lax.Precision.HIGHEST)
        if sm.relax != 1.0:
            xn = xb[blk.rows] + sm.relax * (xn - xb[blk.rows])
        xb = xb.at[blk.rows].set(xn)
    return xb.reshape(-1)


def bsr_smooth(sm: BsrSmootherData, A, x, b, nsweeps: int, forward: bool):
    kind = sm.kind
    for _ in range(nsweeps):
        if kind == SmootherType.JACOBI:
            r = (b - A(x)).reshape(-1, sm.nb)
            dx = jnp.einsum("rab,rb->ra", sm.dinv, r,
                            precision=jax.lax.Precision.HIGHEST).reshape(-1)
            x = x + sm.relax * dx
        elif kind in (int(SmootherType.GS), int(SmootherType.SOR)):
            order = range(len(sm.colors)) if forward else \
                range(len(sm.colors) - 1, -1, -1)
            x = bsr_color_sweep(sm, x, b, order)
        elif kind in (int(SmootherType.SGS), int(SmootherType.SSOR)):
            x = bsr_color_sweep(sm, x, b, range(len(sm.colors)))
            x = bsr_color_sweep(sm, x, b,
                                range(len(sm.colors) - 1, -1, -1))
        else:
            raise ValueError(f"unsupported BSR smoother {kind}")
    return x
