"""Structured (gather-free) UA-AMG setup: the structured fast path.

A statically-shifted banded SpMV streams its operands in order, while an
arbitrary-index gather reads them scattered; this path keeps the whole
cycle gather-free.  This module builds a hierarchy where:

- every level's operator is a :class:`DiaOperator` (banded stencil SpMV —
  shifted multiply-adds only);
- restriction/prolongation are *reshape* pair-aggregation transfers
  (``reshape(..., d/2, 2, ...).sum()`` / broadcast) — no gathers;
- smoothers are Chebyshev / Jacobi / L1-Jacobi / exact red-black GS
  (masked full-stencil updates), never color-gather loops;
- the coarsest solve is a dense inverse matmul.

Algebraically this is unsmoothed aggregation with 2-per-axis pair
aggregates (the reference's UA-AMG with pairwise aggregation,
PreAMGSetupUA.c:55 + aggregation_symmpair, specialized to index-structured
matrices), with exact Galerkin coarse operators.  Grid structure is
*detected from the matrix's diagonal offsets* — the same information the
reference's dSTRmat format carries explicitly (fasp.h:316-348).

The coarse-level Galerkin products are exact (host-side segment-reduction
RAP, fasp_blas_dcsr_rap_agg analog), so structure detection can never
affect correctness — only the choice of aggregation shape.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import SmootherType
from ...formats import CSRMatrix
from ...ops.operators import (DiaOperator, StencilNdOperator, default_dtype,
                              dia_bands_from_csr, dia_fill_ok)
from ...utils.params import AMGParam
from .aggregation import _rap_boolean
from .hierarchy import AMGHierarchy, AMGLevel, make_coarse_solver
from .smoothers import SmootherData

# levels at or above this size use the grid-aware DiaNdOperator (per-axis
# shifts); smaller levels stay flat, where all-nd hierarchies pay odd-nx
# relayouts and per-op overhead on small grids
_ND_OPERATOR_MIN_N = 1 << 19

# levels at or above this size prefer the compressed StencilNdOperator when
# its exact band factorization actually compresses (constant-coefficient /
# Galerkin-coarse stencils): zero band HBM traffic in the SpMV and ~1000x
# smaller host->device transfer
_STENCIL_MIN_N = 1 << 15


def _grid_operator(cur, dtype):
    """Pick the device operator for one structured level: compressed
    stencil where the exact factorization wins, grid-aware full bands for
    large levels, flat DIA for small ones."""
    if cur.n >= _STENCIL_MIN_N:
        op = cur.to_stencil_operator(dtype)
        full = cur.n * len(op.bands) * np.dtype(dtype).itemsize
        if op.device_bytes <= full // 2:
            return op
    if cur.n >= _ND_OPERATOR_MIN_N:
        return cur.to_nd_operator()
    offs_l, flat_l = cur.flat_offsets()
    return DiaOperator(flat_l, tuple(int(o) for o in offs_l), cur.n)


def _compact_vec(v: np.ndarray) -> np.ndarray:
    """Collapse a constant vector to shape (1,) — broadcasts against flat
    vectors everywhere it is used (smoother dinv, smoothed-transfer dinv),
    skipping its host->device transfer."""
    if v.size > 1 and v.flags.c_contiguous and (v == v.flat[0]).all():
        return v[:1].copy()
    return v


# ---------------------------------------------------------------------------
# structure detection
# ---------------------------------------------------------------------------

def detect_dims(offsets, n: int, max_dx: int = 2) -> Optional[Tuple[int, ...]]:
    """Infer grid dims (major..minor, minor = stride 1) from band offsets.

    Returns (n,) for 1D-banded, (ny, nx) / (nz, ny, nx) when the offsets
    cluster around axis strides, or None if no structure is apparent.
    """
    offs = sorted({abs(int(o)) for o in offsets} - {0})
    if n <= 1:
        return None
    if not offs or offs[-1] <= max_dx:
        return (n,)
    small = {o for o in offs if o <= max_dx}
    dx_ok = small | {-o for o in small} | {0}
    rest = [o for o in offs if o > max_dx]
    c0 = rest[0]
    for s in range(max(c0 - max_dx, max_dx + 1), c0 + max_dx + 1):
        if n % s:
            continue
        near = [o for o in rest if abs(o - s) <= max_dx]
        # the decomposed x-component must be an offset the stencil already
        # uses (rejects near-miss strides like s-2 matching a 5-pt stencil)
        if any((o - s) not in dx_ok for o in near):
            continue
        rem = [o for o in rest if abs(o - s) > max_dx]
        if not rem:
            return (n // s, s)
        c1 = rem[0]
        for t in range(max(c1 - s - max_dx, s + 1), c1 + s + max_dx + 1):
            if t % s or n % t:
                continue
            good = True
            for o in rem:
                d = o - t
                dy = int(np.rint(d / s))
                if abs(dy) > 1 or (d - dy * s) not in dx_ok:
                    good = False
                    break
            if good:
                return (n // t, t // s, s)
    return None


# ---------------------------------------------------------------------------
# reshape pair-transfers (device side, zero gathers)
# ---------------------------------------------------------------------------

def _ceil_div(d: int, s: int) -> int:
    return (d + s - 1) // s


def _restrict_once(r, dims: Tuple[int, ...], ax: int, s: int):
    d = dims[ax]
    dc = _ceil_div(d, s)
    v = r.reshape(dims)
    if d % s:
        pad = [(0, 0)] * len(dims)
        pad[ax] = (0, dc * s - d)
        v = jnp.pad(v, pad)
    shape = list(v.shape)
    shape[ax:ax + 1] = [dc, s]
    return v.reshape(shape).sum(axis=ax + 1).reshape(-1)


def _prolong_once(xc, dims: Tuple[int, ...], ax: int, s: int):
    """Adjoint of _restrict_once (boolean P: copy to all group members)."""
    d = dims[ax]
    cdims = list(dims)
    cdims[ax] = _ceil_div(d, s)
    v = xc.reshape(cdims)
    v = jnp.repeat(v, s, axis=ax)
    if d % s:
        idx = [slice(None)] * len(dims)
        idx[ax] = slice(0, d)
        v = v[tuple(idx)]
    return v.reshape(-1)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PairRestrict:
    """Composition of per-axis group restrictions (pure reshapes)."""

    steps: Tuple[Tuple[Tuple[int, ...], int, int], ...] = dataclasses.field(
        metadata=dict(static=True))          # ((dims, ax, s), ...) in order
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_coarse, self.n_fine)

    def __call__(self, r):
        for dims, ax, s in self.steps:
            r = _restrict_once(r, dims, ax, s)
        return r


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PairProlong:
    steps: Tuple[Tuple[Tuple[int, ...], int, int], ...] = dataclasses.field(
        metadata=dict(static=True))
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_fine, self.n_coarse)

    def __call__(self, xc):
        for dims, ax, s in reversed(self.steps):
            xc = _prolong_once(xc, dims, ax, s)
        return xc


def pair_agg_map(dims: Tuple[int, ...], ax: int, s: int = 2
                 ) -> Tuple[np.ndarray, int]:
    """Flat aggregate map of one-axis grouping (for the exact host RAP)."""
    coords = np.unravel_index(np.arange(int(np.prod(dims))), dims)
    cdims = list(dims)
    cdims[ax] = _ceil_div(dims[ax], s)
    ccoords = list(coords)
    ccoords[ax] = coords[ax] // s
    agg = np.ravel_multi_index(ccoords, cdims)
    return agg.astype(np.int64), int(np.prod(cdims))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SmoothedProlong:
    """SA prolongation P = (I - w D^-1 A) P_tent as an operator
    composition over the level's own A — still zero gathers, and no extra
    band arrays to store or transfer (reference:
    amg_setup_smoothP_smoothR, PreAMGSetupSA.c)."""

    A: DiaOperator                      # the level operator (shared)
    dinv: jax.Array
    base: PairProlong
    omega: float = dataclasses.field(metadata=dict(static=True),
                                     default=0.67)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.base.shape

    def __call__(self, xc):
        v = self.base(xc)
        return v - self.omega * (self.dinv * self.A(v))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SmoothedRestrict:
    """R = P^T = P_tent^T (I - w A D^-1) (A symmetric)."""

    A: DiaOperator
    dinv: jax.Array
    base: PairRestrict
    omega: float = dataclasses.field(metadata=dict(static=True),
                                     default=0.67)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.base.shape

    def __call__(self, r):
        return self.base(r - self.omega * self.A(self.dinv * r))


# ---------------------------------------------------------------------------
# setup driver
# ---------------------------------------------------------------------------

def _host_power_lambda(A: CSRMatrix, iters: int = 25) -> float:
    """lambda_max of D^{-1}A by host power iteration (reference:
    fasp_dcsr_maxeig, BlaEigen.c)."""
    m = A.to_scipy()
    d = A.diagonal()
    dinv = 1.0 / np.where(d != 0.0, d, 1.0)
    rng = np.random.default_rng(7)
    v = rng.standard_normal(A.nrow)
    lam = 1.0
    for _ in range(iters):
        w = dinv * (m @ v)
        lam = max(float(np.linalg.norm(w)), 1e-30)
        v = w / lam
    return max(lam, 1e-8) * 1.1


def _offset_coords(o: int, dims: Tuple[int, ...]) -> List[int]:
    """Decompose a flat offset into per-axis components (nearest-stride,
    centered remainders): o = sum comps[i] * stride[i]."""
    strides = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]
    rem = int(o)
    comps = []
    for s in strides[:-1]:
        c = int(np.rint(rem / s))
        comps.append(c)
        rem -= c * s
    comps.append(rem)
    return comps


def _rb_colorable(offsets, dims: Tuple[int, ...]) -> bool:
    """Exact red-black 2-coloring exists iff every stencil offset has odd
    coordinate-sum (5-point/7-point style, no diagonal couplings)."""
    for o in offsets:
        if o == 0:
            continue
        if sum(_offset_coords(int(o), dims)) % 2 == 0:
            return False
    return True


def _parity_masks(dims: Tuple[int, ...], dtype) -> Tuple[np.ndarray, np.ndarray]:
    coords = np.indices(dims)
    parity = coords.sum(axis=0) % 2
    red = (parity == 0).astype(dtype).reshape(-1)
    return red, 1.0 - red


def _freeze_device(tree, dtype):
    """Move every array leaf of a host-built pytree to the device in ONE
    transfer (concatenate -> upload -> on-device split).

    Each host->device transfer has a fixed latency, so a hierarchy with
    ~30 arrays pays it once instead of 30 times.  The split runs as one
    jitted program so it also costs one compile, cached across runs.
    """
    from functools import partial

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if not leaves:
        return tree
    np_dtype = np.dtype(dtype)
    # dedup leaves shared by identity (e.g. a level operator's bands also
    # referenced by its smoothed transfers): upload once, reuse the device
    # array everywhere.  Leaves already on device (eagerly frozen fine
    # level, overlapping its transfer with coarse host setup) pass through.
    slot_of: dict = {}
    arrs = []
    leaf_slot = []
    for l in leaves:
        if isinstance(l, jax.Array):
            leaf_slot.append(l)
            continue
        key = id(l)
        if key not in slot_of:
            slot_of[key] = len(arrs)
            arrs.append(np.asarray(l, dtype=np_dtype))
        leaf_slot.append(slot_of[key])
    if not arrs:
        return tree
    if sum(a.size for a in arrs) * np_dtype.itemsize <= (1 << 22):
        # small tree (compressed stencil hierarchy): a concat+split program
        # costs more (compile-cache load + device program load) than direct
        # device_put transfers, which need no compiled program at all
        dev_s = jax.device_put(arrs)
        return jax.tree_util.tree_unflatten(
            treedef,
            [s if isinstance(s, jax.Array) else dev_s[s]
             for s in leaf_slot])
    layout = []
    off = 0
    for a in arrs:
        layout.append((off, int(a.size), tuple(a.shape)))
        off += int(a.size)
    big = jnp.asarray(np.concatenate([a.ravel() for a in arrs]))

    @partial(jax.jit, static_argnames=("layout",))
    def split(buf, layout):
        return tuple(
            jax.lax.slice(buf, (o,), (o + s,)).reshape(shp)
            for o, s, shp in layout)

    dev = split(big, tuple(layout))
    return jax.tree_util.tree_unflatten(
        treedef,
        [s if isinstance(s, jax.Array) else dev[s] for s in leaf_slot])


def _band_smoother(B, param, dtype, dinv=None) -> SmootherData:
    """Gather-free smoother for a structured level (from a BandMatrix).

    JACOBI / L1DIAG map exactly; GS-family maps to exact red-black GS when
    the stencil is bipartite (5/7-point), else to Chebyshev (documented
    deviation — sequential GS has no gather-free parallel form for
    non-bipartite stencils).  POLY/CHEBYSHEV map to Chebyshev with a Gershgorin
    lambda_max bound (reference computes it by power iteration,
    fasp_dcsr_maxeig; the Gershgorin bound is tight for M-matrices and
    costs one vectorized pass).
    """
    kind = int(param.smoother)
    if dinv is None:
        d = B.diagonal()
        dinv = 1.0 / np.where(d != 0.0, d, 1.0)   # host; frozen later
    if kind in (SmootherType.JACOBI, SmootherType.JACOBIF):
        return SmootherData(kind=int(SmootherType.JACOBI),
                            relax=float(param.relaxation), nsweep_scale=1,
                            dinv=dinv)
    if kind == SmootherType.L1DIAG:
        l1 = np.zeros(B.n)
        for b in B.bands.values():
            l1 += np.abs(b.reshape(-1))
        l1 = np.where(l1 != 0.0, l1, 1.0)
        return SmootherData(kind=kind, relax=float(param.relaxation),
                            nsweep_scale=1, l1inv=_compact_vec(1.0 / l1))
    bipartite = all(sum(c) % 2 for c in B.bands if any(c))
    if kind in (SmootherType.GS, SmootherType.SGS, SmootherType.SOR,
                SmootherType.SSOR, SmootherType.GSOR, SmootherType.SGSOR,
                SmootherType.GSF) and bipartite:
        red, black = _parity_masks(B.dims, np.dtype(dtype))
        return SmootherData(kind=int(SmootherType.RBGS),
                            relax=float(param.relaxation), nsweep_scale=1,
                            dinv=dinv, rb_masks=(red, black))
    # Chebyshev fallback / default
    lam = B.gershgorin_dinv_lambda()
    return SmootherData(kind=int(SmootherType.CHEBYSHEV),
                        relax=float(param.relaxation),
                        nsweep_scale=max(param.polynomial_degree, 2),
                        dinv=dinv,
                        lambda_max=np.asarray(float(lam)))


def setup_structured(A: CSRMatrix, param: Optional[AMGParam] = None,
                     dtype=None,
                     dims: Optional[Tuple[int, ...]] = None,
                     smooth_p: Optional[bool] = None,
                     keep_f64_fine: bool = False,
                     pack: bool = False):
    """Build the gather-free structured hierarchy, or None if the matrix
    has no detectable band structure (callers then fall back to the general
    gather-based path).

    ``smooth_p`` selects SA-style smoothed prolongation (one damped-Jacobi
    sweep on the tentative P, reference: PreAMGSetupSA.c) — on this path it
    stays gather-free because P = (I - w D^-1 A) P_tent is a DIA-op +
    reshape composition.

    The whole setup runs in host band space (band_algebra.BandMatrix):
    Galerkin products are exact per-axis band combinations — no sparse
    SpGEMM, no sorting, O(k^2 n) vectorized NumPy.
    """
    from .band_algebra import BandMatrix

    param = param or AMGParam()
    dtype = dtype or default_dtype()
    if smooth_p is None:
        from ...constants import AMGType
        smooth_p = int(param.AMG_type) == int(AMGType.SA)

    # ONE flat-diagonal extraction serves the fill check, the structure
    # detection, and the BandMatrix construction
    if A.nrow != A.ncol or A.nnz == 0:
        return None
    offsets0, flat0 = dia_bands_from_csr(A)
    if (len(offsets0) > 36 or len(offsets0) * A.nrow > 3 * A.nnz):
        return None          # DIA fill would be wasteful; general path
    if dims is None:
        dims = detect_dims(offsets0, A.nrow)
    if dims is None:
        return None
    # band pipeline runs in the target precision: conformance (f64) is
    # exact; performance mode (f32) halves the setup's memory traffic
    B0 = BandMatrix.from_flat(offsets0, flat0, tuple(dims),
                              dtype=np.dtype(dtype))
    if B0 is None:          # wrap entries / long-range couplings: the flat
        return None         # offsets lied about the structure — fall back

    max_levels = min(param.max_levels, 20)
    coarse_dof = max(param.coarse_dof, 32)

    band_levels: List[BandMatrix] = [B0]
    levels: List[AMGLevel] = []

    # aggregate size per axis: 3 for smoothed-P (classic SA 3^ndim
    # aggregates — keeps the coarse stencil a 3^ndim fixed point; size-2
    # aggregates would grow the smoothed stencil without bound), 2 for UA
    # (pairwise, PreAMGSetupUA.c; 9/27-point fixed point)
    s_agg = 3 if smooth_p else 2

    cur = B0
    while len(band_levels) < max_levels and cur.n > coarse_dof:
        cdims = list(cur.dims)
        steps = []
        # group along every axis with extent > 1: coarsening ratio
        # s_agg^ndim per level
        for ax in range(len(cdims) - 1, -1, -1):
            if cdims[ax] > 1:
                steps.append((tuple(cdims), ax, s_agg))
                cdims[ax] = _ceil_div(cdims[ax], s_agg)
        if not steps or int(np.prod(cdims)) >= cur.n:
            break

        base_P = PairProlong(tuple(steps), cur.n, int(np.prod(cdims)))
        base_R = PairRestrict(tuple(steps), cur.n, int(np.prod(cdims)))

        # grid-aware per-axis shifts for LARGE levels (axis-0 moves are
        # whole-row moves); small/odd-dim grids stay flat (fixed per-op
        # overhead + relayout dominate);
        # exact-compressed stencil bands wherever the factorization wins
        op_l = _grid_operator(cur, dtype)

        d = cur.diagonal()
        dinv = (1.0 / np.where(d != 0.0, d, 1.0)).astype(cur.dtype())
        # device-bound copies broadcast from (1,) when constant; the host
        # band algebra below (native smoothed RAP) needs the full vector
        dinv_c = _compact_vec(dinv)
        sm = _band_smoother(cur, param, dtype, dinv=dinv_c)

        if smooth_p:
            # P = S P_tent with S = I - w D^-1 A  =>
            # Ac = P_tent^T (S^T A S) P_tent, all in band space.  On device
            # the smoothed transfers COMPOSE with the level's own A (shared
            # arrays — nothing extra to store or upload).
            omega = param.tentative_smooth
            P: object = SmoothedProlong(op_l, dinv_c, base_P, float(omega))
            R: object = SmoothedRestrict(op_l, dinv_c, base_R, float(omega))
        else:
            omega = 0.0
            P, R = base_P, base_R
        level = AMGLevel(A=op_l, P=P, R=R, smoother=sm)
        if not levels and not pack and not isinstance(op_l,
                                                      StencilNdOperator):
            # eagerly freeze a full-band (dominant-size) fine level: its
            # host->device transfer streams while the coarse-level band
            # products below run on the host CPU.  A compressed stencil
            # fine level is a few KB — freezing it here would only cost an
            # extra split-program load.
            level = _freeze_device(level, dtype)
        levels.append(level)

        # fused native coarse Galerkin product (one tiled pass, no
        # full-size intermediates); identical algebra to the band
        # matmul + per-axis pair_rap fallback below
        Bc = cur.smoothed_rap_all_axes(dinv if smooth_p else None,
                                       omega, s_agg)
        if Bc is None:
            if smooth_p:
                S = cur.scale_rows(dinv).scaled(-omega).add_identity()
                ST = cur.scale_cols(dinv).scaled(-omega).add_identity()
                inner = ST.matmul(cur.matmul(S))
            else:
                inner = cur
            Bc = inner
            for _, ax, s_ in steps:
                Bc = Bc.pair_rap(ax, s_)
        band_levels.append(Bc)
        cur = Bc

    if len(band_levels) == 1:
        return None

    # coarsest level: dense inverse on-device when small, DIA + Jacobi-CG
    # otherwise
    Bl = band_levels[-1]
    if Bl.n <= 2048:
        from .hierarchy import CoarseSolver
        from ...ops.operators import DenseOperator
        dense = Bl.to_dense()
        levels.append(AMGLevel(A=DenseOperator(dense, Bl.n),
                               P=None, R=None, smoother=None))
        try:
            inv = np.linalg.inv(dense)
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(dense)
        coarse = CoarseSolver(inv=inv)
    else:
        from .hierarchy import IterativeCoarseSolver
        op = _grid_operator(Bl, dtype)
        levels.append(AMGLevel(A=op, P=None, R=None, smoother=None))
        d = Bl.diagonal()
        d = np.where(d != 0.0, d, 1.0)
        coarse = IterativeCoarseSolver(A=op, dinv=_compact_vec(1.0 / d))

    amli_c = ()
    if param.amli_degree > 0:
        from .cycles import amli_coefs
        amli_c = amli_coefs(2.0, 0.5, param.amli_degree)

    hier = AMGHierarchy(
        levels=tuple(levels), coarse=coarse,
        presmooth_iter=param.presmooth_iter,
        postsmooth_iter=param.postsmooth_iter,
        cycle_type=param.cycle_type,
        coarse_scaling=bool(param.coarse_scaling),
        amli_degree=param.amli_degree,
        amli_coefs=amli_c)
    # exact f64 fine operator for device-resident refinement; only
    # worthwhile when the stencil compression makes it ~free to hold
    op64_host = None
    if keep_f64_fine and jax.config.jax_enable_x64:
        B64 = BandMatrix.from_flat(offsets0, flat0, tuple(dims))
        if B64 is not None:
            cand = B64.to_stencil_operator(np.float64)
            if cand.device_bytes <= (1 << 20):
                op64_host = cand

    if pack:
        # packed freeze: ONE program-free transfer per precision; leaves
        # become traced slices inside the consumer's own jitted program
        # (see ops/packing.py for the rationale)
        from ...ops.packing import PackedHierarchy, pack_pytree
        p32 = pack_pytree(hier, dtype)
        if p32 is not None:
            p64 = (pack_pytree(op64_host, np.float64)
                   if op64_host is not None else None)
            return PackedHierarchy(p32=p32, p64=p64)

    # single batched host->device transfer of every array in the hierarchy
    hier = _freeze_device(hier, dtype)
    if op64_host is not None:
        hier = dataclasses.replace(
            hier, fine64=_freeze_device(op64_host, np.float64))
    return hier
