"""Aggregation algorithms for UA/SA-AMG setup (host side).

Reference: PreAMGAggregation.inl:368 (aggregation_vmb, the
Vanek-Mandel-Brezina greedy), PreAMGAggregationUA.inl:363
(aggregation_symmpair, pairwise matching), :1202 (nonsymmetric pairwise).

Setup-phase graph algorithms run on host (numpy) — the same cost model as
the reference, whose setup is serial C; only the solve phase is device code.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ...constants import AggregationType
from ...formats import CSRMatrix


def strength_graph(A: CSRMatrix, theta: float) -> sp.csr_matrix:
    """Symmetric strength-of-connection:
    j in N(i)  iff  |a_ij| >= theta * sqrt(|a_ii a_jj|)
    (reference: aggregation_vmb strongly-coupled neighborhood)."""
    m = A.to_scipy().tocoo()
    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    scale = np.sqrt(d[m.row] * d[m.col])
    keep = (np.abs(m.data) >= theta * scale) & (m.row != m.col)
    S = sp.csr_matrix((np.ones(np.count_nonzero(keep)),
                       (m.row[keep], m.col[keep])), shape=A.shape)
    return S


def aggregate_vmb(A: CSRMatrix, theta: float, max_aggregation: int = 20
                  ) -> Tuple[np.ndarray, int]:
    """VMB greedy aggregation.  Returns (agg_id per node, n_aggregates).

    Three passes (reference: aggregation_vmb, PreAMGAggregation.inl:368):
    1. nodes whose strong neighborhood is entirely unaggregated become the
       root of a new aggregate containing that neighborhood;
    2. remaining nodes join the neighboring aggregate they are most
       strongly connected to;
    3. leftovers form aggregates from their remaining unaggregated
       strong neighbors.
    """
    n = A.nrow
    S = strength_graph(A, theta)
    from ... import native
    out = native.vmb_aggregate(S, max_aggregation)
    if out is not None:
        return out
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0

    # isolated nodes (no strong couplings): keep as singletons at the end
    deg = np.diff(indptr)

    # pass 1
    for i in range(n):
        if agg[i] != -1 or deg[i] == 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if np.all(agg[nbrs] == -1):
            group = nbrs[:max_aggregation - 1]
            agg[i] = nagg
            agg[group] = nagg
            nagg += 1

    # pass 2: attach to strongest neighboring aggregate
    counts = np.bincount(agg[agg >= 0], minlength=max(nagg, 1))
    data = S.data
    for i in range(n):
        if agg[i] != -1 or deg[i] == 0:
            continue
        s, e = indptr[i], indptr[i + 1]
        nbrs = indices[s:e]
        anbrs = agg[nbrs]
        ok = (anbrs >= 0)
        if np.any(ok):
            cand = anbrs[ok]
            snb = data[s:e][ok]
            # strongest connection wins, but respect the size cap
            order = np.argsort(-snb)
            for k in order:
                a = cand[k]
                if counts[a] < max_aggregation:
                    agg[i] = a
                    counts[a] += 1
                    break

    # pass 3: group leftovers with their unaggregated strong neighbors
    for i in range(n):
        if agg[i] != -1 or deg[i] == 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        free = nbrs[agg[nbrs] == -1][:max_aggregation - 1]
        agg[i] = nagg
        agg[free] = nagg
        nagg += 1

    # isolated nodes become singleton aggregates
    for i in range(n):
        if agg[i] == -1:
            agg[i] = nagg
            nagg += 1

    return agg, nagg


def _notay_match_py(A: CSRMatrix, first_pass: bool, k_tg: float
                    ) -> Tuple[np.ndarray, int]:
    """Python twin of native fasp_notay_match (reference: form_pairwise,
    PreAMGAggregationUA.inl:170): matches i with the free neighbor
    minimizing the Notay two-point measure mu, pairing when mu <= k_tg."""
    m = A.to_scipy().tocsr()
    n = A.nrow
    indptr, indices, data = m.indptr, m.indices, m.data
    diag = A.diagonal()
    rows = np.repeat(np.arange(n), np.diff(indptr))
    off = indices != rows
    s = -np.bincount(rows[off], data[off], minlength=n)
    sabs = np.bincount(rows[off], np.abs(data[off]), minlength=n)
    SMALL = 1e-20
    agg = np.full(n, -1, dtype=np.int64)
    if first_pass and k_tg > 1.0:
        agg[diag >= (k_tg + 1.0) / (k_tg - 1.0) * sabs] = -2
    nagg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        lo, hi = indptr[i], indptr[i + 1]
        aii = diag[i]
        min_mu, index = np.inf, -1
        for p in range(lo, hi):
            col = indices[p]
            if col == i or agg[col] != -1:
                continue
            aij = data[p]
            ajj = diag[col]
            t1 = aii + s[i] + 2.0 * aij
            t2 = ajj + s[col] + 2.0 * aij
            t1 = t1 if abs(t1) > SMALL else (SMALL if t1 >= 0 else -SMALL)
            t2 = t2 if abs(t2) > SMALL else (SMALL if t2 >= 0 else -SMALL)
            t2 = 1.0 / t1 + 1.0 / t2
            t2 = t2 if abs(t2) > SMALL else (SMALL if t2 >= 0 else -SMALL)
            t3 = max(abs(aii - s[i]), SMALL)
            t4 = max(abs(ajj - s[col]), SMALL)
            t4 = -aij + 1.0 / (1.0 / t3 + 1.0 / t4)
            t4 = t4 if abs(t4) > SMALL else (SMALL if t4 > 0 else -SMALL)
            mu = (-aij + 1.0 / t2) / t4
            if mu < min_mu:
                min_mu, index = mu, col
        agg[i] = nagg
        if index >= 0 and min_mu <= k_tg:
            agg[index] = nagg
        nagg += 1
    g0 = np.nonzero(agg == -2)[0]
    agg[g0] = nagg + np.arange(len(g0))
    return agg, nagg + len(g0)


def effective_quality_bound(A: CSRMatrix, quality_bound: float) -> float:
    """Reference rule (aggregation_symmpair, PreAMGAggregationUA.inl:380):
    wide-band matrices relax the bound to the bandwidth (max row nnz)."""
    bandwidth = int(A.row_nnz().max()) if A.nrow else 0
    return float(bandwidth) if bandwidth > 5 else float(quality_bound)


def _compose_passes(A: CSRMatrix, k_pairs: int, match_one
                    ) -> Tuple[np.ndarray, int]:
    """Run ``match_one(level_matrix, first_pass)`` per pass, composing the
    per-pass maps through boolean-RAP coarse matrices (the dopass loop of
    aggregation_symmpair)."""
    cur = A
    maps = []
    for it in range(k_pairs):
        pair, nagg = match_one(cur, it == 0)
        maps.append((pair, nagg))
        if nagg >= cur.nrow or it == k_pairs - 1:
            break
        cur = _rap_boolean(cur, pair, nagg)
    agg = maps[0][0].copy()
    for pair, _ in maps[1:]:
        agg = pair[agg]
    return agg, maps[-1][1]


def aggregate_pairwise(A: CSRMatrix, k_pairs: int = 2,
                       quality_bound: float = 8.0) -> Tuple[np.ndarray, int]:
    """(Multi-)pairwise matching aggregation with the Notay quality bound
    (reference: aggregation_symmpair + form_pairwise,
    PreAMGAggregationUA.inl:363,170).  ``k_pairs`` matching passes compose
    to aggregates of size up to 2^k_pairs; each candidate pair must clear
    the two-point quality measure mu <= quality_bound (bandwidth-adjusted
    per the reference rule)."""
    from ... import native

    k_tg = effective_quality_bound(A, quality_bound)

    def match_one(cur, first):
        out = native.notay_match(cur, first, k_tg)
        if out is None:
            out = _notay_match_py(cur, first, k_tg)
        return out

    return _compose_passes(A, k_pairs, match_one)


def aggregate_nsympair(A: CSRMatrix, k_pairs: int = 2,
                       quality_bound: float = 8.0) -> Tuple[np.ndarray, int]:
    """Non-symmetric pairwise matching aggregation (reference:
    aggregation_nsympair, PreAMGAggregationUA.inl:1202 — Napov/Notay 2012
    measure on the symmetrized coupling -0.5(a_ij+a_ji)).

    Later passes apply the first-pass rule to the composed coarse matrix
    (documented deviation: the reference's nsympair_2ndpass re-derives the
    measure from the original matrix).  Callers apply the reference's
    auto-fallback to VMB when matching stalls (PreAMGSetupUA.c:244-256).
    """
    from ... import native

    k_tg = effective_quality_bound(A, quality_bound)

    def match_one(cur, first):
        out = native.nsympair_match(cur, first, k_tg)
        if out is None:
            # no toolchain: symmetrize and use the Python Notay rule
            sym = CSRMatrix.from_scipy(
                ((cur.to_scipy() + cur.to_scipy().T) * 0.5).tocsr())
            out = _notay_match_py(sym, first, k_tg)
        return out

    return _compose_passes(A, k_pairs, match_one)


def _rap_boolean(A: CSRMatrix, agg: np.ndarray, nagg: int) -> CSRMatrix:
    """Ac = P^T A P with boolean P as one vectorized segment reduction —
    the scalar twin of the BSR block RAP (reference fast path:
    fasp_blas_dcsr_rap_agg, BlaSpmvCSR.c:1276)."""
    rows = np.repeat(np.arange(A.nrow), A.row_nnz())
    key = agg[rows].astype(np.int64) * nagg + agg[A.indices]
    order = np.argsort(key)                      # single sort
    key_s = key[order]
    first = np.ones(len(key_s), dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    start = np.flatnonzero(first)
    uniq = key_s[start]
    sums = np.add.reduceat(A.data[order], start)
    out_rows = uniq // nagg
    out_cols = uniq % nagg
    counts = np.bincount(out_rows, minlength=nagg)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return CSRMatrix(indptr, out_cols, sums, (nagg, nagg))


def _match_rounds(eu, ev, escore, nn: int, rounds: int) -> np.ndarray:
    """Luby-style heavy-edge matching, pure NumPy: an edge matches when it
    is the best (lowest-score) free edge of BOTH its endpoints.

    Host-side on purpose: AMG setup is irregular graph work; pushing it to
    the device costs a fresh XLA compile per level shape and round-trip
    transfers, which dominates setup time (measured).  The reference's
    setup is serial C for the same reason (SURVEY.md §7 design stance).
    """
    matched = np.full(nn, -1, dtype=np.int64)
    seg = np.concatenate([eu, ev])
    for _ in range(rounds):
        free = matched == -1
        edge_free = free[eu] & free[ev] & np.isfinite(escore)
        if not edge_free.any():
            break
        s = np.where(edge_free, escore, np.inf)
        nodemin = np.full(nn, np.inf)
        np.minimum.at(nodemin, seg, np.concatenate([s, s]))
        sel = edge_free & (s == nodemin[eu]) & (s == nodemin[ev])
        matched[eu[sel]] = ev[sel]
        matched[ev[sel]] = eu[sel]
    return matched


def aggregate_pairwise_fast(A: CSRMatrix, k_pairs: int = 2,
                            rounds: int = 10, return_coarse: bool = False):
    """Fully vectorized (multi-)pairwise aggregation for large systems.

    Same algorithmic idea as :func:`aggregate_pairwise` (strongest-negative-
    neighbor matching, reference PreAMGAggregationUA.inl:363) expressed as
    Luby matching rounds on the device + segment-reduction RAP on host —
    no Python loop over nodes.  Used automatically above a size threshold.
    With ``return_coarse`` the final Galerkin operator is returned too, so
    callers don't recompute the RAP.
    """
    rng = np.random.default_rng(1234)
    cur = A
    maps = []
    for _ in range(k_pairs):
        nn = cur.nrow
        rows = np.repeat(np.arange(nn), cur.row_nnz())
        cols = cur.indices
        data = cur.data
        # sign-agnostic strength matching: score by -|a_ij| (for M-matrices
        # identical to strongest-negative matching; on UA coarse levels,
        # where positive off-diagonals appear, it keeps the pairing dense
        # instead of stalling)
        canon = (rows < cols) & (data != 0)
        base = -np.abs(data[canon])
        eu, ev = rows[canon], cols[canon]
        ne = len(eu)
        if ne == 0:
            maps.append((np.arange(nn), nn))
            break
        escore = base + rng.random(ne) * \
            (1e-6 * max(np.abs(base).max(), 1.0))
        matched = _match_rounds(eu, ev, escore, nn, rounds).astype(np.int64)
        leader = np.where((matched == -1) | (np.arange(nn) < matched),
                          np.arange(nn), matched)
        uniq, pair = np.unique(leader, return_inverse=True)
        nagg = len(uniq)
        maps.append((pair, nagg))
        cur = _rap_boolean(cur, pair, nagg)
    agg = maps[0][0]
    for pair, _ in maps[1:]:
        agg = pair[agg]
    if return_coarse:
        return agg, maps[-1][1], cur
    return agg, maps[-1][1]


def aggregate(A: CSRMatrix, param, theta: float) -> Tuple[np.ndarray, int]:
    """Dispatch one aggregation pass by ``param.aggregation_type``,
    honoring the configured type (reference: amg_setup_unsmoothP_unsmoothR
    switch, PreAMGSetupUA.c:225-270).  NPAIR auto-falls back to VMB when
    matching stalls (:244-256).  The only substitution happens when no
    native toolchain exists for a large system — and it warns."""
    from ... import native

    t = int(getattr(param, "aggregation_type", AggregationType.PAIRWISE))
    n = A.nrow
    if not native.available() and n > 20000:
        import warnings
        warnings.warn(
            "faspsolver_tpu: no native toolchain — large-system aggregation "
            f"uses the vectorized Luby matching path instead of the "
            f"configured aggregation_type={t}", RuntimeWarning)
        return aggregate_pairwise_fast(A, param.pair_number)
    if t == int(AggregationType.VMB):
        return aggregate_vmb(A, theta, param.max_aggregation)
    if t == int(AggregationType.NPAIR):
        agg, nagg = aggregate_nsympair(A, param.pair_number,
                                       param.quality_bound)
        if nagg * 2.0 > n:     # reference: NPAIR failed -> switch to VMB
            return aggregate_vmb(A, theta, param.max_aggregation)
        return agg, nagg
    return aggregate_pairwise(A, param.pair_number, param.quality_bound)


def tentative_prolongation(agg: np.ndarray, nagg: int) -> CSRMatrix:
    """Boolean tentative P from an aggregation map
    (reference: form_tentative_p, PreAMGAggregationCSR.inl:40)."""
    n = len(agg)
    return CSRMatrix.from_scipy(
        sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, nagg)))


def tentative_prolongation_nk(agg: np.ndarray, nagg: int, B: np.ndarray
                              ) -> Tuple[CSRMatrix, np.ndarray]:
    """Near-kernel tentative prolongation (reference: form_tentative_p
    with AMG_data.near_kernel_basis, fasp.h:849-852; the Vanek SA
    construction): per aggregate a, the m basis columns restricted to a
    are orthonormalized and become coarse dofs a*m..a*m+m-1.

    Batched Loewdin orthonormalization Q = X (X^T X)^{-1/2} — padded rows
    stay exactly zero, so aggregates of different sizes batch into one
    (nagg, max_size, m) einsum + (nagg, m, m) eigh: batched setup.
    Returns (P_tent (n, nagg*m) CSR, coarse basis (nagg*m, m) = the
    (X^T X)^{1/2} factors, i.e. R such that X = Q R).
    """
    n = len(agg)
    m = B.shape[1]
    counts = np.bincount(agg, minlength=nagg)
    max_sz = int(counts.max()) if nagg else 1
    order = np.argsort(agg, kind="stable")
    slot = np.arange(n) - np.concatenate([[0], np.cumsum(counts[:-1])])[agg][order]
    X = np.zeros((nagg, max_sz, m))
    X[agg[order], slot] = B[order]
    G = np.einsum("asm,asn->amn", X, X)               # (nagg, m, m)
    w, V = np.linalg.eigh(G)
    w = np.maximum(w, 1e-30)
    inv_sqrt = np.einsum("amk,ak,ank->amn", V, 1.0 / np.sqrt(w), V)
    sqrt_G = np.einsum("amk,ak,ank->amn", V, np.sqrt(w), V)
    Q = np.einsum("asm,amn->asn", X, inv_sqrt)        # orthonormal columns
    # scatter Q back to (n, nagg*m) CSR: row i gets m entries in block agg[i]
    rows = np.repeat(np.arange(n), m)
    cols = (agg[:, None] * m + np.arange(m)[None, :]).ravel()
    vals = Q[agg[order], slot][np.argsort(order)].reshape(n, m).ravel()
    keep = vals != 0.0
    P = CSRMatrix.from_coo(rows[keep], cols[keep], vals[keep],
                           (n, nagg * m))
    return P, sqrt_G.reshape(nagg * m, m)
