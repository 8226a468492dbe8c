"""BSR-native unsmoothed-aggregation AMG setup (the reservoir/SPE01 path).

Reference: fasp_amg_setup_ua_bsr (PreAMGSetupUABSR.c:55): condense blocks
to a scalar strength graph (condenseBSR, PreAMGAggregationBSR.inl:20),
aggregate there, expand the boolean P to blocks, block RAP
(fasp_blas_dbsr_rap), per-level precomputed block-diagonal inverses.

Device form: the block RAP with boolean P is a pure segment-sum over
(nnzb, nb, nb) block arrays — no SpGEMM; levels carry BsrEllOperator +
block multicolor smoothers.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ...constants import AggregationType
from ...formats import BSRMatrix
from ...ops.operators import BsrEllOperator, default_dtype
from ...utils.params import AMGParam
from .aggregation import aggregate_pairwise, aggregate_vmb
from .bsr_smoothers import build_bsr_smoother
from .hierarchy import (AMGHierarchy, AMGLevel, CoarseSolver, NearKernel,
                        make_coarse_solver)
from .transfer import BlockAggProlong, BlockAggRestrict


def _near_kernel_data(B: np.ndarray, A_host: BSRMatrix, dtype) -> NearKernel:
    """NearKernel for one level: Ainv = pinv(B^T A B) on host (reference:
    A_nk = R_nk A P_nk, PreAMGSetupUABSR.c:265)."""
    m = A_host.to_scipy().tocsr()
    gram = B.T @ (m @ B)
    return NearKernel(B=jnp.asarray(B, dtype=dtype),
                      Ainv=jnp.asarray(np.linalg.pinv(gram), dtype=dtype))


def _restrict_basis_agg(B: np.ndarray, agg: np.ndarray, nagg: int,
                        nb: int) -> np.ndarray:
    """B_{l+1} = R_l B_l for the boolean block-aggregation restriction
    (reference: P_nk_{l+1} = R_l P_nk_l, PreAMGSetupUABSR.c:262)."""
    n = len(agg)
    m = B.shape[1]
    out = np.zeros((nagg, nb, m), dtype=B.dtype)
    np.add.at(out, agg, B.reshape(n, nb, m))
    return out.reshape(nagg * nb, m)


def _block_rap_agg(A: BSRMatrix, agg: np.ndarray, nagg: int) -> BSRMatrix:
    """Ac = P^T A P with boolean block P: sum fine blocks into coarse
    (agg[row], agg[col]) slots — fully vectorized segment reduction
    (reference: fasp_blas_dbsr_rap specialized to boolean P)."""
    nb = A.nb
    rows = np.repeat(np.arange(A.nrow_block), np.diff(A.indptr))
    cr = agg[rows]
    cc = agg[A.indices]
    key = cr * nagg + cc
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, start = np.unique(key_s, return_index=True)
    data_s = A.data[order]
    sums = np.add.reduceat(data_s, start, axis=0)
    out_rows = (uniq // nagg).astype(np.int64)
    out_cols = (uniq % nagg).astype(np.int64)
    indptr = np.zeros(nagg + 1, dtype=np.int64)
    np.add.at(indptr, out_rows + 1, 1)
    indptr = np.cumsum(indptr)
    return BSRMatrix(indptr, out_cols, sums, (nagg, nagg))


def setup_ua_bsr(A: BSRMatrix, param: Optional[AMGParam] = None,
                 dtype=None, nk: Optional[np.ndarray] = None
                 ) -> AMGHierarchy:
    """``nk``: optional (n*nb, m) near-kernel basis carried down the
    hierarchy (restricted per level) with the cycle-level correction
    enabled (reference: fasp_solver_dbsr_krylov_nk_amg, SolBSR.c:634;
    PreAMGSetupUABSR.c:241-266)."""
    param = param or AMGParam()
    dtype = dtype or default_dtype()

    host_levels: List[BSRMatrix] = [A]
    aggs: List[Tuple[np.ndarray, int]] = []

    cur = A
    theta = param.strong_coupled
    max_levels = min(param.max_levels, 20)
    while (len(host_levels) < max_levels
           and cur.nrow_block > max(param.coarse_dof // max(cur.nb, 1), 8)):
        cond = cur.condense(norm_type=0)       # signed Linf (condenseBSRLinf)
        if param.aggregation_type == AggregationType.VMB:
            agg, nagg = aggregate_vmb(cond, theta, param.max_aggregation)
            # reference's BSR adaptive threshold (PreAMGSetupUABSR.c:199-206)
            if nagg * 4 > cond.nrow:
                theta /= 8.0
            elif nagg * 1.25 < cond.nrow:
                theta *= 1.5
        else:
            agg, nagg = aggregate_pairwise(cond, param.pair_number,
                                           param.quality_bound)
        if nagg >= cur.nrow_block:
            break
        Ac = _block_rap_agg(cur, agg, nagg)
        aggs.append((agg, nagg))
        host_levels.append(Ac)
        cur = Ac

    levels = []
    nlvl = len(host_levels)
    B = None
    if nk is not None:
        B = np.atleast_2d(np.asarray(nk, dtype=np.float64))
        if B.shape[0] != A.nrow:
            B = B.T
    for l, Al in enumerate(host_levels):
        nk_data = _near_kernel_data(B, Al, dtype) if B is not None else None
        if l == nlvl - 1:
            levels.append(AMGLevel(
                A=BsrEllOperator.from_bsr(Al, dtype=dtype),
                P=None, R=None, smoother=None, nk=nk_data))
            break
        agg, nagg = aggs[l]
        sm = build_bsr_smoother(Al, param.smoother, relax=param.relaxation,
                                dtype=dtype)
        levels.append(AMGLevel(
            A=BsrEllOperator.from_bsr(Al, dtype=dtype),
            P=BlockAggProlong(jnp.asarray(agg.astype(np.int32)),
                              Al.nrow_block, int(nagg), Al.nb),
            R=BlockAggRestrict(jnp.asarray(agg.astype(np.int32)),
                               Al.nrow_block, int(nagg), Al.nb),
            smoother=sm, nk=nk_data))
        if B is not None:
            B = _restrict_basis_agg(B, agg, int(nagg), Al.nb)

    coarse = make_coarse_solver(host_levels[-1], dtype)

    amli_c = ()
    if param.amli_degree > 0:
        from .cycles import amli_coefs
        amli_c = amli_coefs(2.0, 0.5, param.amli_degree)

    return AMGHierarchy(
        levels=tuple(levels), coarse=coarse,
        presmooth_iter=param.presmooth_iter,
        postsmooth_iter=param.postsmooth_iter,
        cycle_type=param.cycle_type,
        coarse_scaling=bool(param.coarse_scaling),
        amli_degree=param.amli_degree,
        amli_coefs=amli_c)


def setup_sa_bsr(A: BSRMatrix, param: Optional[AMGParam] = None,
                 dtype=None, nk: Optional[np.ndarray] = None
                 ) -> AMGHierarchy:
    """BSR smoothed-aggregation setup (reference: fasp_amg_setup_sa_bsr,
    PreAMGSetupSABSR.c:61): condense blocks to the scalar strength graph,
    aggregate there, expand the tentative P to blocks and smooth it with
    one damped block-Jacobi sweep; Galerkin RAP on the smoothed block P.

    The smoothed block P is a general BSR matrix: transfers become
    BsrEllOperator pairs (P, P^T) instead of boolean block gathers; the
    RAP runs host-side through scipy's BSR product at setup.
    """
    import scipy.sparse as sp

    param = param or AMGParam()
    dtype = dtype or default_dtype()
    nb = A.nb

    host_levels: List[BSRMatrix] = [A]
    Ps: List[BSRMatrix] = []

    cur = A
    theta = param.strong_coupled
    max_levels = min(param.max_levels, 20)
    while (len(host_levels) < max_levels
           and cur.nrow_block > max(param.coarse_dof // max(nb, 1), 8)):
        cond = cur.condense(norm_type=0)       # signed Linf (condenseBSRLinf)
        if param.aggregation_type == AggregationType.VMB:
            agg, nagg = aggregate_vmb(cond, theta, param.max_aggregation)
            if nagg * 4 > cond.nrow:
                theta /= 8.0
            elif nagg * 1.25 < cond.nrow:
                theta *= 1.5
        else:
            agg, nagg = aggregate_pairwise(cond, param.pair_number,
                                           param.quality_bound)
        if nagg >= cur.nrow_block:
            break
        # block tentative P (identity blocks) smoothed by damped Jacobi:
        # P = (I - w D^{-1} A) P_tent, computed in scipy BSR space
        m = cur.to_scipy().tobsr(blocksize=(nb, nb))
        nrb = cur.nrow_block
        eye = np.broadcast_to(np.eye(nb), (nrb, nb, nb))
        Pt = sp.bsr_matrix((np.ascontiguousarray(eye),
                            agg.astype(np.int64),
                            np.arange(nrb + 1, dtype=np.int64)),
                           shape=(nrb * nb, nagg * nb), blocksize=(nb, nb))
        dinv = cur.diag_inv()                     # (nrb, nb, nb)
        Dinv = sp.bsr_matrix((np.ascontiguousarray(dinv),
                              np.arange(nrb, dtype=np.int64),
                              np.arange(nrb + 1, dtype=np.int64)),
                             shape=(nrb * nb, nrb * nb),
                             blocksize=(nb, nb))
        omega = param.tentative_smooth
        P = (Pt - omega * (Dinv @ (m @ Pt))).tobsr(blocksize=(nb, nb))
        Ac_sp = (P.T @ m @ P).tobsr(blocksize=(nb, nb))
        Ac = BSRMatrix(Ac_sp.indptr.astype(np.int64),
                       Ac_sp.indices.astype(np.int64),
                       np.ascontiguousarray(Ac_sp.data),
                       (nagg, nagg))
        Ps.append(BSRMatrix(P.indptr.astype(np.int64),
                            P.indices.astype(np.int64),
                            np.ascontiguousarray(P.data),
                            (nrb, nagg)))
        host_levels.append(Ac)
        cur = Ac

    levels = []
    nlvl = len(host_levels)
    B = None
    if nk is not None:
        B = np.atleast_2d(np.asarray(nk, dtype=np.float64))
        if B.shape[0] != A.nrow:
            B = B.T
    for l, Al in enumerate(host_levels):
        nk_data = _near_kernel_data(B, Al, dtype) if B is not None else None
        if l == nlvl - 1:
            levels.append(AMGLevel(
                A=BsrEllOperator.from_bsr(Al, dtype=dtype),
                P=None, R=None, smoother=None, nk=nk_data))
            break
        P = Ps[l]
        PT_sp = P.to_scipy().T.tobsr(blocksize=(nb, nb))
        PT = BSRMatrix(PT_sp.indptr.astype(np.int64),
                       PT_sp.indices.astype(np.int64),
                       np.ascontiguousarray(PT_sp.data),
                       (P.shape[1], P.shape[0]))
        sm = build_bsr_smoother(Al, param.smoother, relax=param.relaxation,
                                dtype=dtype)
        levels.append(AMGLevel(
            A=BsrEllOperator.from_bsr(Al, dtype=dtype),
            P=BsrEllOperator.from_bsr(P, dtype=dtype),
            R=BsrEllOperator.from_bsr(PT, dtype=dtype),
            smoother=sm, nk=nk_data))
        if B is not None:
            B = np.asarray(P.to_scipy().T @ B)

    coarse = make_coarse_solver(host_levels[-1], dtype)

    amli_c = ()
    if param.amli_degree > 0:
        from .cycles import amli_coefs
        amli_c = amli_coefs(2.0, 0.5, param.amli_degree)

    return AMGHierarchy(
        levels=tuple(levels), coarse=coarse,
        presmooth_iter=param.presmooth_iter,
        postsmooth_iter=param.postsmooth_iter,
        cycle_type=param.cycle_type,
        coarse_scaling=bool(param.coarse_scaling),
        amli_degree=param.amli_degree,
        amli_coefs=amli_c)
