"""Device sparse operators: the solve-phase matrix representations.

Accelerator design (NOT a port of the reference's CSR loops):

The reference's hot kernel is a row-loop CSR SpMV (fasp_blas_dcsr_mxv,
base/src/BlaSpmvCSR.c:242) parallelized with OpenMP.  A scalar row loop is
the wrong shape for a jitted array program, which wants dense, statically
shaped operations that XLA can fuse.  So device operators here use:

- ELL (padded-row) layout: ``cols[n,k]``, ``vals[n,k]`` — SpMV is one gather
  + one elementwise multiply + one row reduction, all dense ops that XLA fuses
  into a single pass.  This is the same insight behind the reference's own
  CSRL "rows grouped by equal nnz" cache format (fasp.h:277-306), taken to
  its array-program conclusion.
- Block-ELL for BSR: ``vals[nbrow,k,nb,nb]`` — SpMV becomes a batched (nb,nb)
  x (nb,) contraction, the analog of the reference's hand-unrolled
  nb∈{2,3,5,7} kernels (BlaSpmvBSR.c:301-412) but expressed once for any nb.
- COO segment-sum fallback for pathologically irregular rows (padding blowup).
- Dense operator for coarse AMG levels (one dense matmul).

All operators are JAX pytrees: they can be passed through jit / vmap /
shard_map boundaries, and a Krylov solver jitted once is reused for any
matrix with the same padded shapes.

Everything matrix-free in the reference (mxv_matfree, fasp.h:1109-1117)
maps to: "an operator is anything with shape/dtype/__call__".
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import BSRMatrix, CSRMatrix


def default_dtype():
    """float64 when jax x64 is enabled (the reference's REAL=double), else
    float32 (the f32 + f64-refinement performance mode)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


# ---------------------------------------------------------------------------
# deferred device placement: under defer_device(), operator constructors
# keep HOST NumPy leaves so a whole hierarchy can be frozen afterwards by
# ONE packed transfer (ops/packing.py) instead of one upload per leaf
# ---------------------------------------------------------------------------

import contextlib as _contextlib
import contextvars as _contextvars

_DEFER_DEVICE = _contextvars.ContextVar("fasp_defer_device", default=False)


@_contextlib.contextmanager
def defer_device():
    """Context: operator/smoother constructors keep NumPy leaves."""
    tok = _DEFER_DEVICE.set(True)
    try:
        yield
    finally:
        _DEFER_DEVICE.reset(tok)


def asdev(a, dtype=None):
    """jnp.asarray, or a plain NumPy array under defer_device()."""
    arr = np.asarray(a) if dtype is None else \
        np.asarray(a, dtype=np.dtype(dtype))
    if _DEFER_DEVICE.get():
        return arr
    return jnp.asarray(arr)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class EllOperator:
    """Padded-ELL sparse operator.

    Rows padded to ``k`` slots; empty slots point at column 0 with value 0.
    ``n`` is the logical dimension; arrays may be row-padded to ``n_pad``
    for tile alignment (extra rows are all-zero).
    """

    cols: jax.Array          # (n_pad, k) int32
    vals: jax.Array          # (n_pad, k)
    n: int = dataclasses.field(metadata=dict(static=True))
    ncol: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.ncol)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0] * self.cols.shape[1])

    def __call__(self, x: jax.Array) -> jax.Array:
        """y = A @ x as gather + fused multiply-reduce."""
        y = jnp.sum(self.vals * x[self.cols], axis=1)
        return y[: self.n] if y.shape[0] != self.n else y

    @classmethod
    def from_csr(cls, A: CSRMatrix, dtype=None, row_align: int = 8,
                 k_min: int = 1) -> "EllOperator":
        dtype = dtype or default_dtype()
        n, ncol = A.shape
        nnz_per_row = A.row_nnz()
        k = max(int(nnz_per_row.max()) if n else 0, k_min)
        n_pad = _round_up(max(n, 1), row_align)
        cols = np.zeros((n_pad, k), dtype=np.int32)
        vals = np.zeros((n_pad, k), dtype=np.dtype(dtype))
        # vectorized CSR->ELL scatter
        if A.nnz:
            rows = np.repeat(np.arange(n), nnz_per_row)
            slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_per_row)
            cols[rows, slot] = A.indices
            vals[rows, slot] = A.data.astype(np.dtype(dtype))
        return cls(asdev(cols), asdev(vals), n, ncol)

    def padding_ratio(self, A_nnz: int) -> float:
        return self.cols.size / max(A_nnz, 1)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DiaOperator:
    """Diagonal (banded / stencil) operator.

    ``bands[k, i] = A[i, i + offsets[k]]`` (row-aligned).  SpMV is a sum of
    statically-shifted elementwise multiplies: zero gathers, one fused
    streaming pass over the bands and x.

    This is the array form of the reference's structured dSTRmat banded
    storage (fasp.h:316-348) and its STR SpMV (BlaSpmvSTR.c), generalized
    to any matrix whose nonzeros live on few distinct diagonals (PDE
    discretizations, Galerkin coarse operators of such).
    """

    bands: jax.Array         # (k, n)
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def ncol(self) -> int:
        return self.n

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def nnz(self) -> int:
        return int(self.bands.size)

    def __call__(self, x: jax.Array) -> jax.Array:
        n = self.n
        pad = max(max(abs(o) for o in self.offsets), 1)
        xp = jnp.pad(x, (pad, pad))
        y = jnp.zeros_like(x)
        for k, off in enumerate(self.offsets):
            y = y + self.bands[k] * jax.lax.slice(
                xp, (pad + off,), (pad + off + n,))
        return y

    def diagonal(self) -> jax.Array:
        for k, off in enumerate(self.offsets):
            if off == 0:
                return self.bands[k]
        return jnp.zeros(self.n, dtype=self.bands.dtype)

    @classmethod
    def from_csr(cls, A: CSRMatrix, dtype=None) -> "DiaOperator":
        dtype = dtype or default_dtype()
        offsets, bands = dia_bands_from_csr(A)
        return cls(asdev(bands.astype(np.dtype(dtype))),
                   tuple(int(o) for o in offsets), A.nrow)

    @classmethod
    def from_bands(cls, offsets, bands: np.ndarray, dtype=None
                   ) -> "DiaOperator":
        dtype = dtype or default_dtype()
        return cls(asdev(np.asarray(bands).astype(np.dtype(dtype))),
                   tuple(int(o) for o in offsets), bands.shape[1])


def pack_bits(mask: np.ndarray) -> np.ndarray:
    """Bit-pack a boolean row mask into int32 words (bit i of word i//32).
    Device unpack is :func:`unpack_bits`; 32x less HBM than an f32 mask."""
    m = np.asarray(mask, dtype=bool)
    n = m.size
    nw = (n + 31) // 32
    padded = np.zeros(nw * 32, dtype=np.uint32)
    padded[:n] = m
    words = (padded.reshape(nw, 32)
             << np.arange(32, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32)
    return words.view(np.int32)


def unpack_bits_np(words: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of :func:`pack_bits` -> (n,) float 0/1."""
    bits = np.unpackbits(np.asarray(words).view(np.uint8),
                         bitorder="little")
    return bits[:n].astype(np.float64)


def unpack_bits(words: jax.Array, n: int, dtype) -> jax.Array:
    """Traced inverse of :func:`pack_bits`: (nw,) int32 -> (n,) 0/1 of
    ``dtype``.  Pure reshape/shift/mask — XLA fuses it into the consumer,
    so the mask never round-trips HBM at full width."""
    bits = jnp.arange(32, dtype=jnp.int32)
    m = (words[:, None] >> bits[None, :]) & 1
    return m.reshape(-1)[:n].astype(dtype)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ConstDiaOperator:
    """DIA bands whose values are ONE scalar each on a row bitmask.

    Classical-AMG coarse operators and grid-transfer bands of
    constant-coefficient problems are constant along each diagonal except
    for a presence pattern (C/F structure, boundaries): ``band_k = c_k *
    mask_k`` exactly.  Storing (scalar, packed bitmask) instead of a full
    (n,) float band cuts the device footprint and SpMV HBM traffic by
    ~32x per band, and the apply stays bit-identical to the full band
    (the mask multiply is exact 0/1).

    Reference analog: the dSTRmat constant-stencil storage
    (fasp.h:316-348) — generalized to any constant diagonal without
    needing grid detection.
    """

    consts: jax.Array        # (k,)
    masks: jax.Array         # (k, nw) int32 bit-packed row masks
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def ncol(self) -> int:
        return self.n

    @property
    def dtype(self):
        return self.consts.dtype

    @property
    def nnz(self) -> int:
        return len(self.offsets) * self.n

    def __call__(self, x: jax.Array) -> jax.Array:
        n = self.n
        pad = max(max(abs(o) for o in self.offsets), 1)
        xp = jnp.pad(x, (pad, pad))
        y = jnp.zeros_like(x)
        for k, off in enumerate(self.offsets):
            m = unpack_bits(self.masks[k], n, x.dtype)
            y = y + (self.consts[k] * m) * jax.lax.slice(
                xp, (pad + off,), (pad + off + n,))
        return y

    def diagonal(self) -> jax.Array:
        for k, off in enumerate(self.offsets):
            if off == 0:
                return self.consts[k] * unpack_bits(
                    self.masks[k], self.n, self.dtype)
        return jnp.zeros(self.n, dtype=self.dtype)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SumOperator:
    """Sum of operator parts (same shape): composes ConstDia + Dia + COO
    pieces of one matrix into a single operator closure."""

    parts: Tuple[Any, ...]

    @property
    def n(self) -> int:
        return self.parts[0].shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.parts[0].shape

    @property
    def ncol(self) -> int:
        return self.parts[0].shape[1]

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def nnz(self) -> int:
        return sum(int(getattr(p, "nnz", 0)) for p in self.parts)

    def __call__(self, x: jax.Array) -> jax.Array:
        y = self.parts[0](x)
        for p in self.parts[1:]:
            y = y + p(x)
        return y

    def diagonal(self) -> jax.Array:
        y = self.parts[0].diagonal()
        for p in self.parts[1:]:
            if hasattr(p, "diagonal"):
                y = y + p.diagonal()
        return y


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DiaNdOperator:
    """Grid-aware banded (stencil) operator: shifts applied PER AXIS.

    The flat DiaOperator's +-row_length offsets are shifts by a whole row
    of the flat vector; with the vector viewed as its (ny, nx) /
    (nz, ny, nx) grid, those become row moves and only the +-1 shifts
    stay within a row (see tools/spmv_explore.py for the layout
    variants).

    ``bands[k]`` is the grid-shaped coefficient array; ``coords[k]`` the
    per-axis offset of band k (BandMatrix convention: the value at grid
    point p multiplies x[p + coord]).  x stays FLAT (n,) outside — the
    reshape to the grid view is free (row-major match).
    """

    bands: jax.Array                      # (k, *dims)
    coords: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True))
    dims: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def ncol(self) -> int:
        return self.n

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def nnz(self) -> int:
        return int(self.bands.size)

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Flat offsets (for halo/diagnostic uses)."""
        st = []
        s = 1
        for d in reversed(self.dims):
            st.append(s)
            s *= d
        st = st[::-1]
        return tuple(sum(c * k for c, k in zip(co, st))
                     for co in self.coords)

    def __call__(self, x: jax.Array) -> jax.Array:
        v = x.reshape(self.dims)
        h = [max((abs(c[a]) for c in self.coords), default=0)
             for a in range(len(self.dims))]
        vp = jnp.pad(v, [(hh, hh) for hh in h])
        y = jnp.zeros_like(v)
        for k, co in enumerate(self.coords):
            start = tuple(hh + c for hh, c in zip(h, co))
            lim = tuple(s + d for s, d in zip(start, self.dims))
            y = y + self.bands[k] * jax.lax.slice(vp, start, lim)
        return y.reshape(-1)

    def diagonal(self) -> jax.Array:
        zero = tuple(0 for _ in self.dims)
        for k, co in enumerate(self.coords):
            if co == zero:
                return self.bands[k].reshape(-1)
        return jnp.zeros(self.n, dtype=self.bands.dtype)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FactoredBand:
    """One stencil band stored as an EXACT distinct-row/column factorization.

    ``band = row_sel @ core @ col_sel`` where ``row_sel`` (d0, r) and
    ``col_sel`` (rc, d1) are 0/1 selector matrices built from
    ``np.unique`` row/column grouping — the reconstruction is exact (each
    output element is a plain copy of one core entry; the selector matmul
    sums exactly one nonzero term).  The products ask for
    ``Precision.HIGHEST``: a default-precision f32 matmul may run in TF32
    on a GPU, which would round the copied entries to 10 mantissa bits.

    Inside the SpMV the band is never materialized: the product is applied
    as a sum of ``r`` rank-1 broadcasts that XLA fuses into the shifted
    multiply-add, so a constant-coefficient stencil costs ZERO band traffic
    from device memory — the device form of the reference's dSTRmat
    constant-stencil storage (fasp.h:316-348).
    """

    row_sel: jax.Array       # (d0, r)
    core: jax.Array          # (r, rc)
    col_sel: jax.Array       # (rc, d1)

    @property
    def dtype(self):
        return self.core.dtype

    @property
    def size(self) -> int:
        return int(self.row_sel.size + self.core.size + self.col_sel.size)

    def apply(self, y, shifted_x):
        """y += band * shifted_x without materializing the band: the
        factorization is expanded as r rank-1 broadcast terms, each fused
        by XLA into the multiply-add stream."""
        w = jnp.matmul(self.core, self.col_sel,          # (r, d1) — tiny
                       precision=jax.lax.Precision.HIGHEST)
        r = int(self.row_sel.shape[1])
        for a in range(r):
            y = y + (self.row_sel[:, a][:, None]
                     * w[a][None, :]) * shifted_x
        return y

    def materialize(self) -> jax.Array:
        return jnp.matmul(self.row_sel,
                          jnp.matmul(self.core, self.col_sel,
                                     precision=jax.lax.Precision.HIGHEST),
                          precision=jax.lax.Precision.HIGHEST)


def factor_band_2d(band: np.ndarray, max_rank: int = 8,
                   min_gain: float = 4.0):
    """EXACT factorization of a 2-D band by distinct-row then distinct-
    column grouping; None when the band does not compress by ``min_gain``.

    Galerkin coarse operators of constant-coefficient stencils have a
    bounded number of distinct rows/columns (interior constant + boundary
    corrections from ragged aggregates), so ``r`` stays small; genuinely
    variable-coefficient bands fail the rank bound and stay dense.
    """
    if band.ndim != 2:
        return None
    d0, d1 = band.shape
    # O(n) distinct-row detection via contiguous runs (np.unique(axis=0)
    # lexsorts all rows — ~50x slower at 1M rows).  Structured-grid bands
    # vary only near boundaries, so distinct rows form a handful of runs;
    # non-contiguous repetition patterns simply stay dense.
    if d0 > 1:
        cont = (band[1:] == band[:-1]).all(axis=1)
        change = np.flatnonzero(~cont)
        if len(change) + 1 > 4 * max_rank:
            return None
        starts = np.concatenate([[0], change + 1])
        reps = band[starts]
        rows_u, inv_small = np.unique(reps, axis=0, return_inverse=True)
        run_id = np.cumsum(np.concatenate([[0], (~cont).astype(np.int64)]))
        row_inv = inv_small.reshape(-1)[run_id]
    else:
        rows_u, row_inv = band, np.zeros(1, dtype=np.int64)
    r = rows_u.shape[0]
    if r > max_rank:
        return None
    cols_u, col_inv = np.unique(rows_u, axis=1, return_inverse=True)
    rc = cols_u.shape[1]
    if r == 1:
        # constant along axis 0: selector collapses to a broadcast scalar
        row_sel = np.ones((1, 1), dtype=band.dtype)
    else:
        row_sel = np.zeros((d0, r), dtype=band.dtype)
        row_sel[np.arange(d0), row_inv.reshape(-1)] = 1.0
    if rc == 1:
        col_sel = np.ones((1, 1), dtype=band.dtype)
    else:
        col_sel = np.zeros((rc, d1), dtype=band.dtype)
        col_sel[col_inv.reshape(-1), np.arange(d1)] = 1.0
    total = row_sel.size + r * rc + col_sel.size
    if total * min_gain > band.size:
        return None
    return row_sel, cols_u, col_sel


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class StencilNdOperator:
    """Grid-aware banded operator with per-band EXACT compression.

    Same shifted multiply-add semantics as :class:`DiaNdOperator`, but each
    band is either a full grid array or a :class:`FactoredBand` — for
    constant-coefficient stencils (FD/FE Poisson, structured-grid Galerkin
    coarse operators) the coefficients collapse to a few KB, so (a) the
    setup's host->device transfer shrinks by ~1000x and (b) the SpMV's HBM
    traffic drops to just the x read + y write (the speed-of-light for any
    matrix-vector product).

    This is the device form of dSTRmat (fasp.h:316-348) / SpMV
    (BlaSpmvSTR.c): the reference also exploits structured-grid stencils
    with dedicated storage; XLA's fusion turns the compressed bands into
    register-resident coefficients.
    """

    bands: Tuple[Any, ...]                # full (dims) array or FactoredBand
    coords: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True))
    dims: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def ncol(self) -> int:
        return self.n

    @property
    def dtype(self):
        b = self.bands[0]
        return b.dtype

    @property
    def nnz(self) -> int:
        return len(self.bands) * self.n

    @property
    def device_bytes(self) -> int:
        """Actual coefficient bytes resident on device (compression gain)."""
        tot = 0
        for b in self.bands:
            tot += (b.size if isinstance(b, FactoredBand)
                    else int(np.prod(b.shape))) * self.dtype.itemsize
        return tot

    @property
    def offsets(self) -> Tuple[int, ...]:
        st = []
        s = 1
        for d in reversed(self.dims):
            st.append(s)
            s *= d
        st = st[::-1]
        return tuple(sum(c * k for c, k in zip(co, st))
                     for co in self.coords)

    def __call__(self, x: jax.Array) -> jax.Array:
        # the shifted slices of one padded array fuse into a single loop
        # whose neighbour reads hit cache: one pass over x and one over y
        v = x.reshape(self.dims)
        h = [max((abs(c[a]) for c in self.coords), default=0)
             for a in range(len(self.dims))]
        vp = jnp.pad(v, [(hh, hh) for hh in h])
        y = jnp.zeros_like(v)
        for k, co in enumerate(self.coords):
            start = tuple(hh + c for hh, c in zip(h, co))
            lim = tuple(s + d for s, d in zip(start, self.dims))
            sx = jax.lax.slice(vp, start, lim)
            b = self.bands[k]
            if isinstance(b, FactoredBand):
                # factorization is (axis0, rest) — flatten trailing axes
                d0 = self.dims[0]
                y = b.apply(y.reshape(d0, -1),
                            sx.reshape(d0, -1)).reshape(self.dims)
            else:
                y = y + b * sx
        return y.reshape(-1)

    def diagonal(self) -> jax.Array:
        zero = tuple(0 for _ in self.dims)
        d0 = self.dims[0]
        rest = self.n // max(d0, 1)
        for k, co in enumerate(self.coords):
            if co == zero:
                b = self.bands[k]
                if isinstance(b, FactoredBand):
                    return jnp.broadcast_to(b.materialize(),
                                            (d0, rest)).reshape(-1)
                return b.reshape(-1)
        return jnp.zeros(self.n, dtype=self.dtype)


def dia_bands_from_csr(A: CSRMatrix) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (offsets, row-aligned bands) from a square CSR matrix.

    Native OpenMP kernel when available (two-pass: offset bitmap, then a
    parallel scatter — the extraction is the setup's single largest host
    pass at ~nnz reads + k*n writes); vectorized NumPy fallback."""
    from .. import native
    nat = native.dia_from_csr(A)
    if nat is not None:
        return nat
    n = A.nrow
    rows = np.repeat(np.arange(n, dtype=np.int64), A.row_nnz())
    off = A.indices.astype(np.int64) - rows
    offsets = np.unique(off)
    pos = np.searchsorted(offsets, off)
    bands = np.zeros((len(offsets), n), dtype=A.data.dtype)
    bands[pos, rows] = A.data
    return offsets, bands


def dia_fill_ok(A: CSRMatrix, max_bands: int = 36,
                fill_limit: float = 3.0) -> bool:
    """Cheap check whether DIA storage is sensible for this matrix."""
    if A.nrow != A.ncol or A.nnz == 0:
        return False
    rows = np.repeat(np.arange(A.nrow, dtype=np.int64), A.row_nnz())
    noffs = len(np.unique(A.indices.astype(np.int64) - rows))
    return (noffs <= max_bands
            and noffs * A.nrow <= fill_limit * A.nnz)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CooOperator:
    """Segment-sum COO operator: fallback for wildly irregular rows where
    ELL padding would blow memory (long-tail degree distributions)."""

    rows: jax.Array          # (nnz_pad,) int32, padded entries -> row n (dropped)
    cols: jax.Array          # (nnz_pad,) int32
    vals: jax.Array          # (nnz_pad,)
    n: int = dataclasses.field(metadata=dict(static=True))
    ncol: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.ncol)

    @property
    def dtype(self):
        return self.vals.dtype

    def __call__(self, x: jax.Array) -> jax.Array:
        prod = self.vals * x[self.cols]
        y = jax.ops.segment_sum(prod, self.rows, num_segments=self.n + 1)
        return y[: self.n]

    @classmethod
    def from_csr(cls, A: CSRMatrix, dtype=None, pad_align: int = 128
                 ) -> "CooOperator":
        dtype = dtype or default_dtype()
        n, ncol = A.shape
        nnz = A.nnz
        nnz_pad = _round_up(max(nnz, 1), pad_align)
        rows = np.full(nnz_pad, n, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=np.dtype(dtype))
        rows[:nnz] = np.repeat(np.arange(n), A.row_nnz())
        cols[:nnz] = A.indices
        vals[:nnz] = A.data.astype(np.dtype(dtype))
        return cls(asdev(rows), asdev(cols), asdev(vals),
                   n, ncol)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BsrEllOperator:
    """Block-ELL operator for BSR matrices.

    SpMV contracts (nbrow, k, nb, nb) blocks against gathered (nbrow, k, nb)
    vector blocks — a batched small contraction, replacing the reference's
    per-nb unrolled scalar code (BlaSpmvBSR.c:301-412).
    """

    cols: jax.Array          # (nbrow, k) int32 block-column ids
    vals: jax.Array          # (nbrow, k, nb, nb)
    nbrow: int = dataclasses.field(metadata=dict(static=True))
    nbcol: int = dataclasses.field(metadata=dict(static=True))
    nb: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        return self.nbrow * self.nb

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nbrow * self.nb, self.nbcol * self.nb)

    @property
    def dtype(self):
        return self.vals.dtype

    def __call__(self, x: jax.Array) -> jax.Array:
        xb = x.reshape(self.nbcol, self.nb)
        gathered = xb[self.cols]                       # (nbrow, k, nb)
        y = jnp.einsum("rkab,rkb->ra", self.vals, gathered,
                       precision=jax.lax.Precision.HIGHEST)
        return y.reshape(-1)

    @classmethod
    def from_bsr(cls, A: BSRMatrix, dtype=None) -> "BsrEllOperator":
        dtype = dtype or default_dtype()
        nbrow, nbcol = A.shape
        nb = A.nb
        nnz_per_row = np.diff(A.indptr)
        k = max(int(nnz_per_row.max()) if nbrow else 0, 1)
        cols = np.zeros((nbrow, k), dtype=np.int32)
        vals = np.zeros((nbrow, k, nb, nb), dtype=np.dtype(dtype))
        if A.nnz_block:
            rows = np.repeat(np.arange(nbrow), nnz_per_row)
            slot = (np.arange(A.nnz_block)
                    - np.repeat(A.indptr[:-1], nnz_per_row))
            cols[rows, slot] = A.indices
            vals[rows, slot] = A.data.astype(np.dtype(dtype))
        return cls(asdev(cols), asdev(vals), nbrow, nbcol, nb)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DenseOperator:
    """Dense operator for coarse AMG levels — one dense matmul.

    The reference gathers coarse grids to a serial direct solver
    (PreMGCycle.c:156-202); here the coarse level lives as a dense matrix
    and both its SpMV and its factorization are dense ops.
    """

    mat: jax.Array           # (n, n)
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.mat.dtype

    def __call__(self, x: jax.Array) -> jax.Array:
        # full-precision matmul: a default-precision f32 matmul may run in
        # TF32 on a GPU — a ~3-digit operator would distort coarse-level
        # corrections
        return jnp.matmul(self.mat, x,
                          precision=jax.lax.Precision.HIGHEST)

    @classmethod
    def from_csr(cls, A: CSRMatrix, dtype=None) -> "DenseOperator":
        dtype = dtype or default_dtype()
        return cls(asdev(A.to_dense(), dtype=dtype), A.nrow)


class _StaticFn:
    """Identity-compared wrapper for static callables.

    A static pytree field participates in jit-cache structure equality;
    if the callable is itself an operator pytree holding jax arrays, that
    comparison tries array equality and crashes.  Identity semantics make
    each closure its own cache entry (a recompile per closure — correct
    for matrix-free operators)."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def __eq__(self, other):
        return self is other or (isinstance(other, _StaticFn)
                                 and other.fn is self.fn)

    def __hash__(self):
        return id(self.fn)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MatFreeOperator:
    """Wrap an arbitrary jittable function as an operator
    (reference: mxv_matfree, fasp.h:1109-1117)."""

    fn: Callable = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    _dtype: Any = dataclasses.field(metadata=dict(static=True))

    def __post_init__(self):
        if not isinstance(self.fn, _StaticFn):
            object.__setattr__(self, "fn", _StaticFn(self.fn))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.fn(x)


# ELL density guard: if padded storage exceeds this multiple of nnz, use COO.
_ELL_PADDING_LIMIT = 3.0


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HybridDiaOperator:
    """DIA + COO-remainder operator: the mostly-banded case.

    Classical-AMG Galerkin coarse operators of grid problems keep most of
    their nonzeros on a few dozen dominant diagonals with a thin irregular
    tail (renumbering defects near boundaries).  Streaming the dominant
    bands gather-free and handling only the tail by gather keeps
    arbitrary-index reads to the few tail entries instead of every
    nonzero."""

    dia: DiaOperator
    rem: CooOperator

    @property
    def n(self) -> int:
        return self.dia.n

    @property
    def shape(self) -> Tuple[int, int]:
        return self.dia.shape

    @property
    def ncol(self) -> int:
        return self.dia.n

    @property
    def dtype(self):
        return self.dia.dtype

    @property
    def nnz(self) -> int:
        return int(self.dia.nnz + self.rem.vals.size)

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.dia(x) + self.rem(x)

    def diagonal(self) -> jax.Array:
        # the COO remainder can carry main-diagonal entries (demoted
        # boundary rows of near-constant bands) — fold them in
        d = self.dia.diagonal()
        on = self.rem.rows == self.rem.cols
        contrib = jnp.where(on, self.rem.vals, 0).astype(d.dtype)
        return d + jax.ops.segment_sum(
            contrib, self.rem.rows, num_segments=self.n + 1)[: self.n]


def best_operator(A: CSRMatrix, dtype=None, max_bands: int = 64,
                  min_band_frac: float = 0.02, min_coverage: float = 0.5,
                  fill_limit: float = 8.0):
    """Adaptive per-level operator selection by sparsity shape:
    pure DIA for banded matrices, DIA+COO hybrid for mostly-banded ones
    (AMG coarse levels of grid problems), ELL/COO otherwise, dense for
    tiny levels.  This is the per-level format dispatch the SURVEY design
    stance calls for ("formats are just different operator
    implementations") — the ALGORITHM stays general; the storage adapts."""
    dtype = dtype or default_dtype()
    n = A.nrow
    if A.nrow != A.ncol or A.nnz == 0:
        return device_operator(A, dtype=dtype)
    if n <= 256:
        return DenseOperator.from_csr(A, dtype=dtype)
    # offset histogram: native OpenMP pass when available, else O(nnz)
    # bincount (np.unique would lexsort all nnz offsets — ~3 s at 7M nnz)
    from .. import native
    rows = off = None
    hist = native.dia_hist(A)
    if hist is None:
        rows = np.repeat(np.arange(n, dtype=np.int64), A.row_nnz())
        off = A.indices.astype(np.int64) - rows
        hist = np.bincount(off + n, minlength=2 * n + 1)
    cand = np.nonzero(hist >= max(min_band_frac * n, 1))[0]
    order = cand[np.argsort(-hist[cand])][:max_bands]
    # trim the sparse tail: dense bands (>=10% filled) always pay off;
    # thinner ones only until 90% coverage — past that the COO remainder
    # is cheaper than streaming a nearly-empty band
    csum = np.cumsum(hist[order])
    keep_n = int(np.searchsorted(csum, 0.9 * A.nnz) + 1)
    dense_n = int((hist[order] >= 0.1 * n).sum())
    order = order[:max(keep_n, dense_n, 1)]
    # symmetric completion: keep offsets in +/- pairs so the banded part
    # of a (structurally) symmetric matrix stays symmetric — a top-k cut
    # that keeps +d but drops -d makes the DIA part nonsymmetric, which
    # breaks the filtered smoother (Chebyshev on a nonsymmetric operator
    # can amplify) and SPD-preconditioner guarantees
    mirror = 2 * n - order
    extra = mirror[(hist[mirror] > 0) & ~np.isin(mirror, order)]
    if extra.size:
        order = np.concatenate([order, extra])
    covered = int(hist[order].sum())
    if (len(order) == 0 or covered < min_coverage * A.nnz
            or len(order) * n > fill_limit * A.nnz):
        return device_operator(A, dtype=dtype)
    keep_offs = np.sort(order.astype(np.int64) - n)
    nrem = A.nnz - covered
    pad = _round_up(max(nrem, 1), 128)
    nat = native.dia_split(A, keep_offs, dtype, nrem, pad) \
        if rows is None else None
    if nat is not None:
        bands, r_rows, r_cols, r_vals = nat
    else:
        if rows is None:
            rows = np.repeat(np.arange(n, dtype=np.int64), A.row_nnz())
            off = A.indices.astype(np.int64) - rows
        # direct offset->band-slot map (searchsorted over nnz costs ~1 s
        # at 7M)
        slot_arr = np.full(2 * n + 1, -1, dtype=np.int32)
        slot_arr[keep_offs + n] = np.arange(len(keep_offs), dtype=np.int32)
        slots = slot_arr[off + n]
        inband = slots >= 0
        bands = np.zeros((len(keep_offs), n), dtype=np.dtype(dtype))
        bands[slots[inband], rows[inband]] = A.data[inband]
        r_rows = np.full(pad, n, dtype=np.int32)
        r_cols = np.zeros(pad, dtype=np.int32)
        r_vals = np.zeros(pad, dtype=np.dtype(dtype))
        if nrem:
            outb = ~inband
            r_rows[:nrem] = rows[outb]
            r_cols[:nrem] = A.indices[outb]
            r_vals[:nrem] = A.data[outb]
    if nrem == 0:
        # fully banded: grid-detectable levels compress to an exact
        # factored stencil (KB instead of MB of band transfer)
        from ..precond.amg.band_algebra import BandMatrix
        from ..precond.amg.structured import detect_dims
        dims = detect_dims(keep_offs, n)
        if dims is not None and len(dims) > 1:
            B = BandMatrix.from_flat(keep_offs, bands, tuple(dims))
            if B is not None:
                st = B.to_stencil_operator(np.dtype(dtype))
                if st.device_bytes <= bands.nbytes // 2:
                    if _DEFER_DEVICE.get():
                        return st
                    return jax.tree_util.tree_map(jnp.asarray, st)
    # constant-band compression; in f32 performance mode near-constant
    # bands demote their few non-modal entries (boundary rows) into the
    # COO remainder, so Galerkin coarse levels ship as scalar x bitmask
    # (~32x less transfer + SpMV traffic) instead of full bands.  The
    # apply stays exact; f64 conformance mode keeps bit-strict bands.
    demote = np.dtype(dtype) == np.float32
    if demote:
        cc, e_rows, e_cols, e_vals = _const_compress_dia(
            bands, keep_offs, n, dtype, demote=True)
    else:
        cc = _const_compress_dia(bands, keep_offs, n, dtype)
        e_rows = np.zeros(0, np.int64)
        e_cols = e_rows
        e_vals = np.zeros(0, np.dtype(dtype))
    dia = cc or DiaOperator(asdev(bands),
                            tuple(int(o) for o in keep_offs), n)
    total_rem = nrem + int(e_rows.size)
    if total_rem == 0:
        return dia
    if e_rows.size:
        pad2 = _round_up(total_rem, 128)
        m_rows = np.full(pad2, n, dtype=np.int32)
        m_cols = np.zeros(pad2, dtype=np.int32)
        m_vals = np.zeros(pad2, dtype=np.dtype(dtype))
        m_rows[:nrem] = r_rows[:nrem]
        m_cols[:nrem] = r_cols[:nrem]
        m_vals[:nrem] = r_vals[:nrem]
        m_rows[nrem:total_rem] = e_rows
        m_cols[nrem:total_rem] = e_cols
        m_vals[nrem:total_rem] = e_vals
        r_rows, r_cols, r_vals = m_rows, m_cols, m_vals
    rem = CooOperator(asdev(r_rows), asdev(r_cols), asdev(r_vals), n, n)
    return HybridDiaOperator(dia=dia, rem=rem)


def _const_compress_dia(bands: np.ndarray, offs, n: int, dtype,
                        min_const: int = 2, demote: bool = False):
    """Split DIA bands into constant (scalar x bitmask) and full parts.

    A band compresses when EVERY nonzero equals one value — the apply is
    then bit-identical to the full band (exact 0/1 mask multiply), so
    this is safe for conformance-mode f64 hierarchies too.  Returns a
    ConstDiaOperator / SumOperator(const, full) when at least
    ``min_const`` bands compress (and n is large enough to matter), else
    None.  Classical-AMG coarse operators of constant-coefficient
    problems compress almost entirely (measured: 8/9 bands at the first
    FE coarse level).

    ``demote=True`` additionally compresses NEAR-constant bands by
    masking out the few non-modal entries (boundary rows of Galerkin
    coarse operators) and returning them as extra COO triples — the
    apply stays exact (band contributes 0 where the mask is cleared; the
    COO carries the full value).  Return value is then a tuple
    ``(op_or_None, extra_rows, extra_cols, extra_vals)``."""
    extras = ([], [], [])
    if n < 4096:
        return (None, *map(np.asarray, extras)) if demote else None
    const_k, full_k = [], []
    for k in range(bands.shape[0]):
        band = bands[k]
        nzidx = np.flatnonzero(band)
        if nzidx.size == 0:
            const_k.append((k, 0.0, band != 0))
            continue
        # candidate constant = mode of a sample (the FIRST nonzero is
        # often an atypical boundary row), then verify every entry.
        # Equality is in the TARGET dtype: f64 Galerkin bands carry
        # ~1e-10 summation noise around their constant, which vanishes
        # under the f32 cast — so the f32 performance path compresses
        # where f64 conformance (bit-strict) keeps full bands.
        sample = band[nzidx[:: max(1, nzidx.size // 512)]]
        v, c = np.unique(sample, return_counts=True)
        v0 = v[c.argmax()]
        if v0 == 0.0:
            full_k.append(k)
            continue
        exc = nzidx[band[nzidx] != v0]
        if exc.size == 0:
            const_k.append((k, float(v0), band != 0))
        elif demote and exc.size <= max(0.05 * nzidx.size, 32):
            # near-constant: clear the exceptional rows from the mask
            # and ship their (row, col, full value) through the COO side
            mask = np.zeros(n, dtype=bool)
            mask[nzidx] = True
            mask[exc] = False
            const_k.append((k, float(v0), mask))
            extras[0].append(exc)
            extras[1].append(exc + int(offs[k]))
            extras[2].append(band[exc])
        else:
            full_k.append(k)

    def _ex():
        if not extras[0]:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.dtype(dtype)))
        return (np.concatenate(extras[0]), np.concatenate(extras[1]),
                np.concatenate(extras[2]))

    if len(const_k) < min_const:
        # no compression: the caller keeps the FULL bands (which still
        # contain any would-be-demoted entries), so the extras must be
        # dropped here — returning them would double-count
        if demote:
            return (None, np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.dtype(dtype)))
        return None
    consts = np.array([c for _, c, _ in const_k], dtype=np.dtype(dtype))
    masks = np.stack([pack_bits(m) for _, _, m in const_k])
    cop = ConstDiaOperator(asdev(consts), asdev(masks),
                           tuple(int(offs[k]) for k, _, _ in const_k), n)
    if not full_k:
        return (cop, *_ex()) if demote else cop
    fop = DiaOperator(asdev(bands[full_k]),
                      tuple(int(offs[k]) for k in full_k), n)
    out = SumOperator(parts=(cop, fop))
    return (out, *_ex()) if demote else out


def device_operator(A, dtype=None, prefer: Optional[str] = None):
    """Build the best device operator for a host matrix.

    ELL when row lengths are regular (the common PDE case), COO segment-sum
    otherwise; BSR matrices get the block-ELL path.
    """
    if isinstance(A, BSRMatrix):
        return BsrEllOperator.from_bsr(A, dtype=dtype)
    if not isinstance(A, CSRMatrix):
        raise TypeError(f"cannot build device operator from {type(A)}")
    if prefer == "coo":
        return CooOperator.from_csr(A, dtype=dtype)
    if prefer == "dia":
        return DiaOperator.from_csr(A, dtype=dtype)
    if prefer == "dense" or (prefer is None and A.nrow <= 256):
        return DenseOperator.from_csr(A, dtype=dtype)
    # banded matrices get the gather-free DIA path (PDE stencils and their
    # Galerkin coarse operators)
    if prefer is None and dia_fill_ok(A):
        return DiaOperator.from_csr(A, dtype=dtype)
    ell = EllOperator.from_csr(A, dtype=dtype)
    if prefer == "ell" or ell.padding_ratio(A.nnz) <= _ELL_PADDING_LIMIT:
        return ell
    return CooOperator.from_csr(A, dtype=dtype)


def expand_compressed(op):
    """Materialize a compressed (scalar x bitmask) operator into plain
    banded form — TRACEABLE, meant to run ONCE at the top of a jitted
    solve program.  The compressed forms unpack their bitmasks inside
    ``__call__``; traced inside a Krylov ``while_loop`` that unpacking
    re-runs EVERY iteration (XLA does not reliably hoist loop-invariant
    bit-unpacking out of while bodies), costing milliseconds per cycle
    at 100k+ rows.  Expanding first keeps the pack/upload savings while
    the solve reads plain bands.  Returns the operator unchanged when
    there is nothing to expand."""
    if isinstance(op, ConstDiaOperator):
        bands = jnp.stack([
            op.consts[k] * unpack_bits(op.masks[k], op.n, op.dtype)
            for k in range(len(op.offsets))])
        return DiaOperator(bands, op.offsets, op.n)
    if isinstance(op, SumOperator):
        parts = tuple(expand_compressed(p) for p in op.parts)
        # merge adjacent DIA parts so the apply is one banded pass
        if (len(parts) == 2 and isinstance(parts[0], DiaOperator)
                and isinstance(parts[1], DiaOperator)):
            a, b = parts
            return DiaOperator(jnp.concatenate([a.bands, b.bands]),
                               a.offsets + b.offsets, a.n)
        return SumOperator(parts=parts)
    if isinstance(op, HybridDiaOperator):
        return HybridDiaOperator(dia=expand_compressed(op.dia),
                                 rem=op.rem)
    return op
