"""Incomplete LU factorization preconditioners.

Reference: base/src/BlaILU.c (fasp_iluk :72, fasp_ilut :467, fasp_ilutp
:906 — SPARSKIT-style row-wise IKJ factorization), BlaILUSetupCSR.c:40
(dispatch), PreCSR.c:198 (fasp_precond_ilu: z = U^{-1} L^{-1} r).

Device apply: sequential triangular solves don't vectorize, so the
apply uses *level-scheduled* batched substitution — rows grouped into
dependency levels; each level is one dense gather+reduce step.  This is the
same strategy as the reference's own parallel ILU appliers
(topologic_sort_ILU / fasp_precond_dbsr_ilu_ls_omp, BlaILUSetupBSR.c,
PreBSR.c:844) taken to its batched conclusion (SURVEY.md §2.9).

Factorization itself is a setup-phase host algorithm (scipy.sparse.spilu
for ILUt-style drop-tolerance factorization; a pure-python IKJ ILU(k) for
level-of-fill semantics).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..constants import ERROR_SOLVER_ILUSETUP, ILUType
from ..formats import CSRMatrix
from ..ops.operators import default_dtype
from ..utils.errors import FaspError
from ..utils.params import ILUParam


# ---------------------------------------------------------------------------
# factorization (host, setup phase)
# ---------------------------------------------------------------------------

def iluk_factor(A: CSRMatrix, lfil: int = 0
                ) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """ILU(k): level-of-fill incomplete factorization
    (reference: fasp_symbfactor + fasp_iluk, BlaILU.c:72).

    Two passes: a symbolic level-of-fill pass fixes the pattern, then a
    numeric IKJ pass fills it.  Explicit zeros in the input count as
    pattern entries (level 0), matching the reference's pattern-driven
    symbolic factorization.  Returns (L, U), L unit-diagonal.
    """
    n = A.nrow
    m = A.to_scipy().tocsr().copy()
    m.sort_indices()

    # ---- symbolic pass: per-row {col: fill-level} -------------------------
    import bisect
    upper_patterns: List[dict] = []    # levels of U-part rows (j >= i)
    full_patterns: List[set] = []      # complete row patterns
    for i in range(n):
        lev = {int(c): 0 for c in m.indices[m.indptr[i]:m.indptr[i + 1]]}
        lev[i] = 0
        work = sorted(c for c in lev if c < i)
        w = 0
        while w < len(work):
            k = work[w]
            w += 1
            lev_ik = lev[k]
            for j, lev_kj in upper_patterns[k].items():
                if j <= k:
                    continue
                l_new = lev_ik + lev_kj + 1
                if j in lev:
                    if l_new < lev[j]:
                        lev[j] = l_new
                elif l_new <= lfil:
                    lev[j] = l_new
                    if j < i:
                        # new dependency must be eliminated in order
                        bisect.insort(work, j)
        upper_patterns.append({j: lv for j, lv in lev.items() if j >= i})
        full_patterns.append(set(lev))

    # ---- numeric pass over the fixed pattern ------------------------------
    Urows: List[dict] = []
    Lrows: List[dict] = []
    for i in range(n):
        row = {j: 0.0 for j in full_patterns[i]}
        s, e = m.indptr[i], m.indptr[i + 1]
        for idx in range(s, e):
            row[int(m.indices[idx])] = m.data[idx]
        for k in sorted(c for c in row if c < i):
            uk = Urows[k]
            ukk = uk.get(k, 0.0)
            if ukk == 0.0:
                continue
            lik = row[k] / ukk
            row[k] = lik
            for j, ukj in uk.items():
                if j > k and j in row:
                    row[j] -= lik * ukj
        Urows.append({j: v for j, v in row.items() if j >= i})
        Lrows.append({j: v for j, v in row.items() if j < i})

    # ---- assemble CSR without canonicalization surprises ------------------
    def build(rows_list, extra_diag):
        indptr = [0]
        indices = []
        data = []
        for i, row in enumerate(rows_list):
            items = sorted(row.items())
            if extra_diag:
                items.append((i, 1.0))
                items.sort()
            indices.extend(j for j, _ in items)
            data.extend(v for _, v in items)
            indptr.append(len(indices))
        return sp.csr_matrix((np.array(data), np.array(indices),
                              np.array(indptr)), shape=(n, n))

    return build(Lrows, True), build(Urows, False)


def ilut_factor(A: CSRMatrix, droptol: float = 1e-3, lfil: int = None
                ) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """ILUt: threshold-based incomplete factorization
    (reference: fasp_ilut, BlaILU.c:467).  Uses SuperLU's ILUTP through
    scipy (drop tolerance + column permutation disabled for symmetry with
    the reference's default)."""
    n = A.nrow
    fill = 10.0 if lfil is None else max(float(lfil), 1.0)
    ilu = sp.linalg.spilu(A.to_scipy().tocsc(), drop_tol=droptol,
                          fill_factor=fill, permc_spec="NATURAL",
                          diag_pivot_thresh=0.0)
    # spilu returns Pr A Pc = L U; NATURAL + diag_pivot_thresh=0 keeps the
    # perms identity — EXCEPT when a zero diagonal forces SuperLU to
    # row-pivot anyway.  Discarding such a perm would silently corrupt the
    # preconditioner, so verify and make the caller take the pivoted path.
    if not (np.array_equal(ilu.perm_r, np.arange(n))
            and np.array_equal(ilu.perm_c, np.arange(n))):
        raise FaspError(ERROR_SOLVER_ILUSETUP,
                        "ILUt: SuperLU pivoted despite NATURAL ordering "
                        "(zero diagonal?) — use ILUtp")
    return ilu.L.tocsr(), ilu.U.tocsr()


def ilutp_factor(A: CSRMatrix, droptol: float = 1e-3, permtol: float = 0.05
                 ) -> Tuple[sp.csr_matrix, sp.csr_matrix, np.ndarray]:
    """ILUtp with partial pivoting (reference: fasp_ilutp, BlaILU.c:906)."""
    ilu = sp.linalg.spilu(A.to_scipy().tocsc(), drop_tol=droptol,
                          fill_factor=10.0)
    return ilu.L.tocsr(), ilu.U.tocsr(), (ilu.perm_r, ilu.perm_c)


# ---------------------------------------------------------------------------
# level-scheduled triangular solve (device, solve phase)
# ---------------------------------------------------------------------------

def _level_schedule(T: sp.csr_matrix, lower: bool) -> List[np.ndarray]:
    """Topological levels of the triangular dependency DAG
    (reference: topologic_sort_ILU, BlaILUSetupBSR.c).  Uses the native
    C++ kernel when available; NumPy loop fallback."""
    n = T.shape[0]
    indptr, indices = T.indptr, T.indices
    from .. import native
    out = native.level_schedule(indptr, indices, n, lower)
    if out is not None:
        depth_nat, nlev = out
        return [np.nonzero(depth_nat == lv)[0] for lv in range(nlev)]
    depth = np.zeros(n, dtype=np.int64)
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        s, e = indptr[i], indptr[i + 1]
        dmax = 0
        for j in indices[s:e]:
            if (lower and j < i) or ((not lower) and j > i):
                dmax = max(dmax, depth[j] + 1)
        depth[i] = dmax
    nlev = int(depth.max()) + 1 if n else 0
    return [np.nonzero(depth == lv)[0] for lv in range(nlev)]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _TriLevel:
    rows: jax.Array      # (m,)  rows solved at this level
    cols: jax.Array      # (m,k) off-diagonal dependency columns
    vals: jax.Array      # (m,k)
    dinv: jax.Array      # (m,)  1/diagonal for these rows


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _TriScan:
    """A run of consecutive small levels executed as ONE lax.scan step
    sequence — bounds trace/compile size for factors whose level count
    grows with n.
    Rows are padded with the scratch index n; padded dinv = 0 writes 0."""

    rows: jax.Array      # (L, m_pad)
    cols: jax.Array      # (L, m_pad, k_pad)
    vals: jax.Array      # (L, m_pad, k_pad)
    dinv: jax.Array      # (L, m_pad)


# unroll everything below this many levels (status quo for shipped data);
# above it, big levels stay unrolled and runs of small levels are scanned
_UNROLL_LEVEL_CAP = 48


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TriangularSolver:
    """Level-scheduled sparse triangular solve as a sequence of batched
    gather+reduce steps.  Deep schedules (level counts grow like n^(1/2)
    to n on 2-D/3-D factors) compile as lax.scan segments instead of one
    traced kernel per level."""

    segments: Tuple[object, ...]   # _TriLevel | _TriScan, in level order
    n: int = dataclasses.field(metadata=dict(static=True))

    def __call__(self, b: jax.Array) -> jax.Array:
        xp = jnp.zeros(self.n + 1, dtype=b.dtype)
        bp = jnp.concatenate([b, jnp.zeros(1, dtype=b.dtype)])
        for seg in self.segments:
            if isinstance(seg, _TriLevel):
                acc = jnp.sum(seg.vals * xp[seg.cols], axis=1)
                xp = xp.at[seg.rows].set(
                    seg.dinv * (bp[seg.rows] - acc))
            else:
                def body(x, lv):
                    rows, cols, vals, dinv = lv
                    acc = jnp.sum(vals * x[cols], axis=1)
                    return x.at[rows].set(dinv * (bp[rows] - acc)), None
                xp, _ = jax.lax.scan(
                    body, xp, (seg.rows, seg.cols, seg.vals, seg.dinv))
        return xp[: self.n]

    @classmethod
    def from_sparse(cls, T: sp.csr_matrix, lower: bool, dtype=None
                    ) -> "TriangularSolver":
        dtype = dtype or default_dtype()
        np_dtype = np.dtype(dtype)
        T = T.tocsr()
        T.sort_indices()
        n = T.shape[0]
        d = T.diagonal()
        d = np.where(d != 0.0, d, 1.0)
        level_rows = _level_schedule(T, lower)

        def pack(rows):
            """(rows, cols (m,k), vals, dinv) — fully vectorized."""
            sub = T[rows, :].tocsr()
            rr = np.repeat(np.arange(len(rows)), np.diff(sub.indptr))
            keep = (sub.indices < rows[rr]) if lower \
                else (sub.indices > rows[rr])
            kr = rr[keep]
            counts = np.bincount(kr, minlength=len(rows))
            k = max(int(counts.max()) if len(rows) else 0, 1)
            cols = np.zeros((len(rows), k), dtype=np.int32)
            vals = np.zeros((len(rows), k), dtype=np_dtype)
            if kr.size:
                starts = np.concatenate([[0], np.cumsum(counts[:-1])])
                slot = np.arange(len(kr)) - starts[kr]
                cols[kr, slot] = sub.indices[keep]
                vals[kr, slot] = sub.data[keep]
            return rows.astype(np.int32), cols, vals, \
                (1.0 / d[rows]).astype(np_dtype)

        packed = [pack(rows) for rows in level_rows]
        segments = []
        if len(packed) <= _UNROLL_LEVEL_CAP:
            for rows, cols, vals, dinv in packed:
                segments.append(_TriLevel(
                    rows=jnp.asarray(rows), cols=jnp.asarray(cols),
                    vals=jnp.asarray(vals), dinv=jnp.asarray(dinv)))
        else:
            sizes = np.array([len(p[0]) for p in packed])
            big_cut = max(64.0, 4.0 * float(np.median(sizes)))
            run = []

            def flush_run():
                if not run:
                    return
                m_pad = max(len(p[0]) for p in run)
                k_pad = max(p[1].shape[1] for p in run)
                L = len(run)
                rows = np.full((L, m_pad), n, dtype=np.int32)
                cols = np.zeros((L, m_pad, k_pad), dtype=np.int32)
                vals = np.zeros((L, m_pad, k_pad), dtype=np_dtype)
                dinv = np.zeros((L, m_pad), dtype=np_dtype)
                for li, (r, c, v, di) in enumerate(run):
                    m = len(r)
                    rows[li, :m] = r
                    cols[li, :m, : c.shape[1]] = c
                    vals[li, :m, : v.shape[1]] = v
                    dinv[li, :m] = di
                segments.append(_TriScan(
                    rows=jnp.asarray(rows), cols=jnp.asarray(cols),
                    vals=jnp.asarray(vals), dinv=jnp.asarray(dinv)))
                run.clear()

            for p in packed:
                if len(p[0]) > big_cut:
                    flush_run()
                    segments.append(_TriLevel(
                        rows=jnp.asarray(p[0]), cols=jnp.asarray(p[1]),
                        vals=jnp.asarray(p[2]), dinv=jnp.asarray(p[3])))
                else:
                    run.append(p)
            flush_run()
        return cls(segments=tuple(segments), n=n)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ILUPrecond:
    """z = U^{-1} L^{-1} r via level-scheduled solves
    (reference: fasp_precond_ilu, PreCSR.c:198).

    For pivoted factorizations (ILUtp) the row/column permutations apply
    around the solves: w[perm_r] = r; z = U^{-1} L^{-1} w; out = z[perm_c]
    (verified against scipy's spilu.solve)."""

    Lsolve: TriangularSolver
    Usolve: TriangularSolver
    perm_in: Optional[jax.Array] = None     # inverse row permutation
    perm_out: Optional[jax.Array] = None    # column permutation

    def __call__(self, r: jax.Array) -> jax.Array:
        if self.perm_in is not None:
            r = r[self.perm_in]
        z = self.Usolve(self.Lsolve(r))
        if self.perm_out is not None:
            z = z[self.perm_out]
        return z


# ---------------------------------------------------------------------------
# Block ILU(0) for BSR (reference: fasp_ilu_dbsr_setup, BlaILUSetupBSR.c;
# appliers fasp_precond_dbsr_ilu / _ilu_ls_omp, PreBSR.c:347,844)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _BTriLevel:
    rows: jax.Array      # (m,)        block rows solved at this level
    cols: jax.Array      # (m,k)       off-diagonal block columns
    vals: jax.Array      # (m,k,nb,nb) dependency blocks
    dinv: jax.Array      # (m,nb,nb)   inverse diagonal blocks (identity in L)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockTriangularSolver:
    """Level-scheduled BLOCK triangular solve: each level is one batched
    (m,k,nb,nb)x(m,k,nb) contraction + a batched (m,nb,nb)x(m,nb) solve —
    the batched conclusion of the reference's level-scheduled BSR ILU
    appliers (fasp_precond_dbsr_ilu_ls_omp, PreBSR.c:844)."""

    levels: Tuple[_BTriLevel, ...]
    n: int = dataclasses.field(metadata=dict(static=True))   # block rows

    def __call__(self, b: jax.Array) -> jax.Array:
        """b: (n, nb) block vector."""
        nb = b.shape[1]
        xp = jnp.zeros((self.n + 1, nb), dtype=b.dtype)
        bp = jnp.concatenate([b, jnp.zeros((1, nb), dtype=b.dtype)])
        for lv in self.levels:
            hi = jax.lax.Precision.HIGHEST
            acc = jnp.einsum("mkab,mkb->ma", lv.vals, xp[lv.cols],
                             precision=hi)
            rhs = bp[lv.rows] - acc
            xp = xp.at[lv.rows].set(jnp.einsum("mab,mb->ma", lv.dinv, rhs,
                                               precision=hi))
        return xp[: self.n]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BSRILUPrecond:
    """z = U^{-1} L^{-1} r with true nb x nb block ILU(0) factors
    (reference: fasp_ilu_dbsr_setup + fasp_precond_dbsr_ilu,
    BlaILUSetupBSR.c, PreBSR.c:347) — no CSR expansion."""

    Lsolve: BlockTriangularSolver
    Usolve: BlockTriangularSolver
    nb: int = dataclasses.field(metadata=dict(static=True))

    def __call__(self, r: jax.Array) -> jax.Array:
        rb = r.reshape(-1, self.nb)
        z = self.Usolve(self.Lsolve(rb))
        return z.reshape(-1)


def _block_levels(n, indptr, indices, vals, dinv, lower, dtype):
    """Pack one triangle of the factored BSR pattern into level batches."""
    nb = vals.shape[1]
    np_dtype = np.dtype(dtype)
    rows_all = np.repeat(np.arange(n), np.diff(indptr))
    tri = (indices < rows_all) if lower else (indices > rows_all)
    tri_counts = np.bincount(rows_all[tri], minlength=n)
    # dependency levels over the block triangle
    tri_indptr = np.concatenate([[0], np.cumsum(tri_counts)]).astype(np.int32)
    tri_indices = indices[tri].astype(np.int32)
    from .. import native
    out = native.level_schedule(tri_indptr, tri_indices, n, lower)
    if out is not None:
        depth, nlev = out
        level_rows = [np.nonzero(depth == lv)[0] for lv in range(nlev)]
    else:
        depth = np.zeros(n, dtype=np.int64)
        order = range(n) if lower else range(n - 1, -1, -1)
        for i in order:
            deps = tri_indices[tri_indptr[i]:tri_indptr[i + 1]]
            depth[i] = (depth[deps].max() + 1) if len(deps) else 0
        nlev = int(depth.max()) + 1 if n else 0
        level_rows = [np.nonzero(depth == lv)[0] for lv in range(nlev)]

    tri_vals = vals[tri]
    eye = np.broadcast_to(np.eye(nb, dtype=np_dtype), (1, nb, nb))
    levels = []
    for rows in level_rows:
        counts = tri_counts[rows]
        k = max(int(counts.max()) if len(rows) else 0, 1)
        m = len(rows)
        cols = np.full((m, k), n, dtype=np.int32)
        blks = np.zeros((m, k, nb, nb), dtype=np_dtype)
        starts = tri_indptr[rows]
        for s in range(k):
            has = counts > s
            cols[has, s] = tri_indices[starts[has] + s]
            blks[has, s] = tri_vals[starts[has] + s]
        di = dinv[rows].astype(np_dtype) if not lower \
            else np.broadcast_to(eye, (m, nb, nb)).copy()
        levels.append(_BTriLevel(
            rows=jnp.asarray(rows.astype(np.int32)),
            cols=jnp.asarray(cols), vals=jnp.asarray(blks),
            dinv=jnp.asarray(di)))
    return levels


def setup_bsr_ilu0(A, dtype=None) -> BSRILUPrecond:
    """Block ILU(0) on the BSR pattern with batched nb x nb apply
    (reference: fasp_ilu_dbsr_setup, BlaILUSetupBSR.c).  Raises FaspError
    when the factorization fails (missing/singular diagonal block) so
    callers can fall back to the CSR expansion path."""
    dtype = dtype or default_dtype()
    from .. import native
    n = A.nrow_block
    nb = A.nb
    # canonical sorted block rows
    indptr = A.indptr.astype(np.int64)
    indices = A.indices.astype(np.int64)
    data = A.data
    order = np.lexsort((indices, np.repeat(np.arange(n), np.diff(indptr))))
    indices = indices[order]
    data = data[order]

    out = native.bsr_ilu0(indptr, indices, data, n, nb)
    if out is None:
        out = _bsr_ilu0_py(n, nb, indptr, indices, data)
    if out is None:
        raise FaspError(ERROR_SOLVER_ILUSETUP, "block ILU(0) setup failed")
    fvals, dinv = out
    return BSRILUPrecond(
        Lsolve=BlockTriangularSolver(
            levels=tuple(_block_levels(n, indptr, indices, fvals, dinv,
                                       True, dtype)), n=n),
        Usolve=BlockTriangularSolver(
            levels=tuple(_block_levels(n, indptr, indices, fvals, dinv,
                                       False, dtype)), n=n),
        nb=nb)


def _bsr_ilu0_py(n, nb, indptr, indices, data):
    """NumPy twin of native fasp_bsr_ilu0 (block IKJ in the A pattern)."""
    vals = np.array(data, dtype=np.float64, copy=True)
    dinv = np.zeros((n, nb, nb))
    pos = {}
    try:
        for i in range(n):
            s, e = int(indptr[i]), int(indptr[i + 1])
            pos = {int(indices[p]): p for p in range(s, e)}
            for p in range(s, e):
                k = int(indices[p])
                if k >= i:
                    break
                vals[p] = vals[p] @ dinv[k]
                for q in range(int(indptr[k]), int(indptr[k + 1])):
                    j = int(indices[q])
                    if j <= k or j not in pos:
                        continue
                    vals[pos[j]] -= vals[p] @ vals[q]
            if i not in pos:
                return None
            dinv[i] = np.linalg.inv(vals[pos[i]])
    except np.linalg.LinAlgError:
        return None
    return vals, dinv


def setup_ilu(A: CSRMatrix, param: ILUParam = None, dtype=None) -> ILUPrecond:
    """Factor + build device solvers (reference: fasp_ilu_dcsr_setup,
    BlaILUSetupCSR.c:40)."""
    param = param or ILUParam()
    dtype = dtype or default_dtype()
    t = int(param.ILU_type)
    from .. import native

    # ILUt/ILUtp row-fill budget: the reference ignores ILU_lfil for the
    # threshold variants and uses n/2+1 so droptol governs fill
    # (BlaILUSetupCSR.c:68-72); an explicit positive lfil still bounds rows
    lfilt = param.ILU_lfil if param.ILU_lfil > 0 else A.nrow // 2 + 1

    def _pivoted() -> ILUPrecond:
        # native ILUtp first (reference: fasp_ilutp, BlaILU.c:906 — own
        # row-wise ILUT with column pivoting); factors satisfy L U ~= A P,
        # solve x = y[argsort(perm)].  SuperLU only as last resort.
        out = native.ilutp(A, lfilt, param.ILU_droptol,
                           param.ILU_permtol)
        if out is not None:
            L, U, perm = out
            return ILUPrecond(
                Lsolve=TriangularSolver.from_sparse(L, lower=True,
                                                    dtype=dtype),
                Usolve=TriangularSolver.from_sparse(U, lower=False,
                                                    dtype=dtype),
                perm_out=jnp.asarray(np.argsort(perm).astype(np.int32)))
        L, U, (perm_r, perm_c) = ilutp_factor(A, param.ILU_droptol,
                                              param.ILU_permtol)
        return ILUPrecond(
            Lsolve=TriangularSolver.from_sparse(L, lower=True, dtype=dtype),
            Usolve=TriangularSolver.from_sparse(U, lower=False, dtype=dtype),
            perm_in=jnp.asarray(np.argsort(perm_r).astype(np.int32)),
            perm_out=jnp.asarray(perm_c.astype(np.int32)))

    if t == ILUType.ILUK:
        out = native.iluk(A, param.ILU_lfil)
        if out is not None:
            L, U = out
        elif A.nrow <= 20000:
            L, U = iluk_factor(A, param.ILU_lfil)
        else:   # no toolchain and too big for the python ILU(k): ILUt
            try:
                L, U = ilut_factor(A, param.ILU_droptol)
            except FaspError:           # zero diagonal forced pivoting
                return _pivoted()
    elif t == ILUType.ILUTP:
        return _pivoted()
    else:
        out = native.ilut(A, lfilt, param.ILU_droptol)
        if out is not None:
            L, U = out
        else:
            try:
                L, U = ilut_factor(A, param.ILU_droptol,
                                   None if param.ILU_lfil == 0
                                   else param.ILU_lfil)
            except FaspError:
                return _pivoted()
    return ILUPrecond(
        Lsolve=TriangularSolver.from_sparse(L, lower=True, dtype=dtype),
        Usolve=TriangularSolver.from_sparse(U, lower=False, dtype=dtype))
