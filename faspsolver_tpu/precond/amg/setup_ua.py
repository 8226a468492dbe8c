"""Unsmoothed-aggregation AMG setup.

Reference: fasp_amg_setup_ua (PreAMGSetupUA.c:55) ->
amg_setup_unsmoothP_unsmoothR (:101): per level {aggregate -> boolean
tentative P -> Ac = P^T A P (rap_agg)} until the coarse grid is small,
with an adaptive strength threshold per level (:234-238) and graceful
termination when aggregation stalls.

Device artifacts per level: ELL operator for A, gather/segment transfer
ops (no P matrix materialized — the whole point of UA), smoother
data, dense-LU coarsest solver.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ...constants import AggregationType, SmootherType
from ...formats import CSRMatrix
from ...ops.operators import (DenseOperator, EllOperator, default_dtype,
                              device_operator)
from ...utils.params import AMGParam
from .aggregation import _rap_boolean, aggregate, tentative_prolongation
from .hierarchy import (AMGHierarchy, AMGLevel, CoarseSolver,
                        make_coarse_solver)
from .smoothers import build_smoother
from .transfer import AggProlong, AggRestrict


def setup_ua(A: CSRMatrix, param: Optional[AMGParam] = None,
             dtype=None, structured: Optional[bool] = None) -> AMGHierarchy:
    param = param or AMGParam()
    dtype = dtype or default_dtype()

    # fast path: large banded matrices get the gather-free structured
    # hierarchy (DIA operators + reshape pair transfers) — see structured.py.
    # Honesty rule (same as aggregate()'s substitution warning): the
    # structured hierarchy IS pairwise aggregation specialized to grid
    # structure, so it only auto-engages when the configured aggregation is
    # compatible (PAIRWISE / NPAIR / default); a user who explicitly asked
    # for VMB keeps the general path unless they pass structured=True.
    if structured is None:
        compatible = int(param.aggregation_type) in (
            int(AggregationType.PAIRWISE), int(AggregationType.NPAIR))
        structured = A.nrow > 100_000 and compatible
    if structured:
        from .structured import setup_structured
        hier = setup_structured(A, param, dtype=dtype)
        if hier is not None:
            return hier

    host_levels: List[CSRMatrix] = [A]
    aggs: List[Tuple[np.ndarray, int]] = []

    cur = A
    theta = param.strong_coupled
    max_levels = min(param.max_levels, 20)
    while (len(host_levels) < max_levels
           and cur.nrow > max(param.coarse_dof, 1)):
        agg, nagg = aggregate(cur, param, theta)
        if nagg >= 0.95 * cur.nrow:   # aggregation stalled -> stop here
            break
        Ac = _rap_boolean(cur, agg, nagg)
        aggs.append((agg, nagg))
        # adaptive per-level strength threshold
        # (reference: PreAMGSetupUA.c:234-238)
        if nagg * 4.0 > cur.nrow:
            theta *= 0.5
        elif nagg * 1.25 < cur.nrow:
            theta *= 2.0
        host_levels.append(Ac)
        cur = Ac

    return build_hierarchy_from_host(host_levels, aggs, param, dtype)


def build_hierarchy_from_host(host_levels: List[CSRMatrix],
                              aggs: List[Tuple[np.ndarray, int]],
                              param: AMGParam, dtype) -> AMGHierarchy:
    """Freeze host CSR levels + aggregation maps into the device hierarchy."""
    levels = []
    nlvl = len(host_levels)
    for l, Al in enumerate(host_levels):
        if l == nlvl - 1:
            levels.append(AMGLevel(A=device_operator(Al, dtype=dtype,
                                                     prefer="dense"
                                                     if Al.nrow <= 2048
                                                     else None),
                                   P=None, R=None, smoother=None))
            break
        agg, nagg = aggs[l]
        op = EllOperator.from_csr(Al, dtype=dtype)
        sm = build_smoother(Al, param.smoother, relax=param.relaxation,
                            poly_degree=param.polynomial_degree, dtype=dtype)
        levels.append(AMGLevel(
            A=op,
            P=AggProlong.from_agg(agg, nagg),
            R=AggRestrict(jnp.asarray(agg.astype(np.int32)), len(agg),
                          int(nagg)),
            smoother=sm))

    coarse = make_coarse_solver(host_levels[-1], dtype)

    amli_c = ()
    if param.amli_degree > 0:
        from .cycles import amli_coefs
        amli_c = amli_coefs(2.0, 0.5, param.amli_degree)

    # UA cycle-robustness rule (reference: amg_setup_unsmoothP_unsmoothR
    # tail, PreAMGSetupUA.c:110,384-402): per-level coarse-visit counts
    # from the complexity formula xsi^lvl / (eta * fracratio * icum),
    # clamped to [1,2], consumed by the NL-AMLI cycle
    # (PreMGRecurAMLI.c:385); when the operator complexity exceeds
    # cplxmax=3.0 a V-cycle request upgrades to nonlinear AMLI
    # (SURVEY §2.5 UA row: complexity-based cycle upgrade).
    from ...constants import CycleType
    cycle_type = param.cycle_type
    nnz0 = max(host_levels[0].nnz, 1)
    op_cplx = sum(h.nnz for h in host_levels) / nnz0
    cplxmax, xsi = 3.0, 0.6
    if op_cplx > cplxmax and cycle_type == int(CycleType.V):
        cycle_type = int(CycleType.NL_AMLI)
    level_visits = ()
    if nlvl > 2:
        eta = xsi / ((1.0 - xsi) * (cplxmax - 1.0))
        icum = 1
        visits = [1]
        for lvl in range(1, nlvl - 1):
            frac = host_levels[lvl].nnz / nnz0
            v = int(xsi ** lvl / (eta * frac * icum))
            v = max(1, min(2, v))
            visits.append(v)
            icum *= v
        level_visits = tuple(visits)

    return AMGHierarchy(
        levels=tuple(levels), coarse=coarse,
        presmooth_iter=param.presmooth_iter,
        postsmooth_iter=param.postsmooth_iter,
        cycle_type=cycle_type,
        coarse_scaling=bool(param.coarse_scaling),
        amli_degree=param.amli_degree,
        amli_coefs=amli_c,
        level_visits=level_visits)
