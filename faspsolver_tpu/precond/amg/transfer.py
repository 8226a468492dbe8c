"""Grid-transfer operators (prolongation / restriction) as device pytrees.

Reference: boolean aggregation transfer (form_tentative_p,
PreAMGAggregationCSR.inl:40; fast paths mxv_agg / rap_agg,
BlaSpmvCSR.c:438,1276) and general sparse P/R from classical/smoothed
interpolation (PreAMGInterp.c).

Device form: a boolean (unsmoothed-aggregation) P never materializes as a
matrix — prolongation is a gather ``x_f = x_c[agg]`` and restriction is a
``segment_sum`` — which is exactly why the reference special-cases boolean P.
General P/R use the ELL operator.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ...formats import CSRMatrix
from ...ops.operators import CooOperator, EllOperator, default_dtype


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AggProlong:
    """Boolean tentative prolongation from an aggregation map."""

    agg: jax.Array      # (n_fine,) int32 aggregate id per fine dof
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_fine, self.n_coarse)

    def __call__(self, xc: jax.Array) -> jax.Array:
        return xc[self.agg]

    @classmethod
    def from_agg(cls, agg: np.ndarray, n_coarse: int) -> "AggProlong":
        from ...ops.operators import asdev
        return cls(asdev(agg.astype(np.int32)), len(agg), int(n_coarse))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AggRestrict:
    """Boolean restriction (transpose of AggProlong): segment sum."""

    agg: jax.Array
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_coarse, self.n_fine)

    def __call__(self, rf: jax.Array) -> jax.Array:
        return jax.ops.segment_sum(rf, self.agg, num_segments=self.n_coarse)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockAggProlong:
    """Blockwise boolean prolongation: fine block i takes coarse block
    agg[i] (reference: form_boolean_p_bsr, PreAMGAggregationBSR.inl)."""

    agg: jax.Array
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))
    nb: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_fine * self.nb, self.n_coarse * self.nb)

    def __call__(self, xc: jax.Array) -> jax.Array:
        return xc.reshape(self.n_coarse, self.nb)[self.agg].reshape(-1)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockAggRestrict:
    agg: jax.Array
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))
    nb: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_coarse * self.nb, self.n_fine * self.nb)

    def __call__(self, rf: jax.Array) -> jax.Array:
        rb = rf.reshape(self.n_fine, self.nb)
        return jax.ops.segment_sum(
            rb, self.agg, num_segments=self.n_coarse).reshape(-1)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CooProlong:
    """General sparse prolongation in COO form.  The SAME three arrays
    serve the transposed restriction (:class:`CooRestrict` holds
    references to them), so R = P^T costs zero extra device memory —
    unlike the reference's explicit fasp_dcsr_trans copy."""

    rows: jax.Array      # (nnz_pad,) int32 fine ids (pad -> n_fine, dropped)
    cols: jax.Array      # (nnz_pad,) int32 coarse ids (pad -> n_coarse)
    vals: jax.Array      # (nnz_pad,)
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_fine, self.n_coarse)

    @property
    def dtype(self):
        return self.vals.dtype

    def __call__(self, xc: jax.Array) -> jax.Array:
        prod = self.vals * xc[self.cols]
        y = jax.ops.segment_sum(prod, self.rows,
                                num_segments=self.n_fine + 1,
                                indices_are_sorted=True)
        return y[: self.n_fine]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CooRestrict:
    """R = P^T applied straight off P's COO arrays (shared, see
    :class:`CooProlong`): gather by fine row, segment-sum by coarse col."""

    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_coarse, self.n_fine)

    @property
    def dtype(self):
        return self.vals.dtype

    def __call__(self, xf: jax.Array) -> jax.Array:
        prod = self.vals * xf[self.rows]
        y = jax.ops.segment_sum(prod, self.cols,
                                num_segments=self.n_coarse + 1)
        return y[: self.n_coarse]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BandedProlong:
    """Gather-frugal prolongation: static shifted reads in FINE index space.

    Coarse dof ``j`` is pinned to fine position ``fpos[j]`` (its C-point's
    fine index, injective).  Embedding the coarse vector there
    (``xe[fpos] = xc``) turns every entry ``P[i, j]`` into a FINE-space
    shift ``d = fpos[j] - i``; for grid-born interpolation (classical RS
    on any detectable grid, incl. the reference's P1-FE meshes) ``d``
    takes only a handful of values, so the apply is

        ``y[i] = sum_k w[k][i] * xe[i + shift_k]  (+ COO remainder)``

    — statically shifted streaming reads, the same 165x-vs-gather trade
    the DIA SpMV rides (CLAUDE.md ground truth), with ONE nc-sized
    scatter to embed instead of an nnz(P)-sized gather + segment_sum.
    Correct for ANY injective fpos by construction (the shift set is
    derived from P itself); efficiency is what depends on the geometry.

    Reference: transfer applies are plain SpMVs inside the MG cycle
    (PreMGCycle.c:135-227, BlaSpmvCSR.c:242); this is their banded device
    form.
    """

    fpos: jax.Array      # (n_coarse,) int32 fine position of coarse dof j
    w: jax.Array         # (k, n_fine) band weights in fine row space;
                         # (k, 1) dummy zeros under const_mode
    rem_rows: jax.Array  # (nnz_rem_pad,) int32 fine ids (pad -> n_fine)
    rem_cols: jax.Array  # (nnz_rem_pad,) int32 coarse ids (pad -> n_coarse)
    rem_vals: jax.Array  # (nnz_rem_pad,)
    shifts: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))
    has_rem: bool = dataclasses.field(metadata=dict(static=True))
    # constant-band encoding (w[k] = wc[k] * bitmask): grid-born
    # interpolation weights are constant per shift away from boundaries,
    # so the bands ship as one scalar + a 1-bit/row mask — ~32x less
    # transfer and SpMV traffic, bit-identical apply (exact 0/1 mask)
    wc: Optional[jax.Array] = None          # (k,) band constants
    wm: Optional[jax.Array] = None          # (k, nw) int32 packed masks
    const_mode: bool = dataclasses.field(metadata=dict(static=True),
                                         default=False)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_fine, self.n_coarse)

    @property
    def dtype(self):
        return self.wc.dtype if self.const_mode else self.w.dtype

    def _band(self, k, dtype):
        if self.const_mode:
            from ...ops.operators import unpack_bits
            return self.wc[k] * unpack_bits(self.wm[k], self.n_fine,
                                            dtype)
        return self.w[k]

    def __call__(self, xc: jax.Array) -> jax.Array:
        nf = self.n_fine
        xe = jnp.zeros(nf, dtype=xc.dtype).at[self.fpos].set(
            xc, unique_indices=True)
        pad = max(max((abs(s) for s in self.shifts), default=0), 1)
        xp = jnp.pad(xe, (pad, pad))
        y = jnp.zeros(nf, dtype=xc.dtype)
        for k, s in enumerate(self.shifts):
            y = y + self._band(k, xc.dtype) * jax.lax.slice(
                xp, (pad + s,), (pad + s + nf,))
        if self.has_rem:
            prod = self.rem_vals * xc[self.rem_cols]
            y = y + jax.ops.segment_sum(prod, self.rem_rows,
                                        num_segments=nf + 1)[:nf]
        return y


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BandedRestrict:
    """R = P^T off the same banded data (see :class:`BandedProlong`):
    ``ye = sum_k shift(w[k] * xf, +shift_k)`` then ONE nc-sized extract
    ``yc = ye[fpos]`` — zero large gathers, zero segment_sums on the
    banded part."""

    fpos: jax.Array
    w: jax.Array
    rem_rows: jax.Array
    rem_cols: jax.Array
    rem_vals: jax.Array
    shifts: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n_fine: int = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))
    has_rem: bool = dataclasses.field(metadata=dict(static=True))
    wc: Optional[jax.Array] = None
    wm: Optional[jax.Array] = None
    const_mode: bool = dataclasses.field(metadata=dict(static=True),
                                         default=False)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_coarse, self.n_fine)

    @property
    def dtype(self):
        return self.wc.dtype if self.const_mode else self.w.dtype

    def _band(self, k, dtype):
        if self.const_mode:
            from ...ops.operators import unpack_bits
            return self.wc[k] * unpack_bits(self.wm[k], self.n_fine,
                                            dtype)
        return self.w[k]

    def __call__(self, xf: jax.Array) -> jax.Array:
        nf = self.n_fine
        pad = max(max((abs(s) for s in self.shifts), default=0), 1)
        ye = jnp.zeros(nf, dtype=xf.dtype)
        for k, s in enumerate(self.shifts):
            t = self._band(k, xf.dtype) * xf
            tp = jnp.pad(t, (pad, pad))
            ye = ye + jax.lax.slice(tp, (pad - s,), (pad - s + nf,))
        yc = ye[self.fpos]
        if self.has_rem:
            prod = self.rem_vals * xf[self.rem_rows]
            yc = yc + jax.ops.segment_sum(
                prod, self.rem_cols,
                num_segments=self.n_coarse + 1)[: self.n_coarse]
        return yc


def banded_transfer(P: CSRMatrix, fpos: np.ndarray, dtype=None,
                    max_shifts: int = 40, max_rem_frac: float = 0.2,
                    max_bytes_ratio: float = 3.0):
    """Build (BandedProlong, BandedRestrict) from P and the fine positions
    of its coarse columns, or None when P doesn't band-compress (too many
    distinct shifts / bands would out-weigh COO) — callers fall back to
    :func:`csr_transfer`.

    Shift selection: keep the most-populated fine-space shifts (at most
    ``max_shifts``); leftover entries ride a small COO remainder capped at
    ``max_rem_frac`` of nnz.  Bands are rejected if they'd cost more than
    ``max_bytes_ratio`` x the COO bytes (DIA's usual fill trade)."""
    from ...ops.operators import _round_up, asdev
    dtype = dtype or default_dtype()
    nf, nc = P.shape
    nnz = P.nnz
    if nnz == 0 or nc == 0:
        return None
    fpos = np.asarray(fpos, dtype=np.int64)
    if fpos.shape[0] != nc:
        return None
    rows = np.repeat(np.arange(nf, dtype=np.int64), np.diff(P.indptr))
    cols = P.indices.astype(np.int64)
    d = fpos[cols] - rows
    # O(nnz) histogram over the shift range (-nf, nf) — np.unique would
    # lexsort all nnz(P) shifts (~0.3 s at the 1M fine level)
    hist = np.bincount(d + nf, minlength=2 * nf + 1)
    pos_nz = np.nonzero(hist)[0]
    uniq = pos_nz - nf
    counts = hist[pos_nz]
    order = np.argsort(-counts, kind="stable")
    kept = order[:max_shifts]
    covered = int(counts[kept].sum())
    if nnz - covered > max_rem_frac * nnz:
        return None
    # demote kept shifts that earn less than their streaming cost (each
    # band streams a full nf lane) into the remainder, budget permitting
    kept = list(kept)
    rem_budget = int(max_rem_frac * nnz) - (nnz - covered)
    thin = max(nf // 256, 8)
    for idx in sorted(kept, key=lambda i: counts[i]):   # thinnest first
        c = int(counts[idx])
        if len(kept) > 1 and c <= thin and rem_budget >= c:
            kept.remove(idx)
            rem_budget -= c
    kept = np.array(kept, dtype=np.int64)
    if kept.size == 0:
        return None
    itemsize = np.dtype(dtype).itemsize
    coo_bytes = nnz * (itemsize + 8)
    # NOTE: the byte-ratio rejection happens AFTER constant-band
    # detection below — a lane that compresses to scalar x bitmask costs
    # nf/8 bytes, not nf*itemsize, and grid-born interpolation compresses
    # almost entirely; rejecting on the full-band estimate here would
    # push perfectly banded mid-level transfers onto the COO gather path
    # lane assignment (deterministic: shifts sorted by value); direct
    # shift->lane lookup table instead of an inverse-index pass
    kept_sorted = np.sort(uniq[kept])
    lane_arr = np.full(2 * nf + 1, -1, dtype=np.int32)
    lane_arr[kept_sorted + nf] = np.arange(len(kept_sorted),
                                           dtype=np.int32)
    lane = lane_arr[d + nf]
    sel = lane >= 0
    # ---- constant-band detection: grid-born interpolation weights are
    # one value per shift away from boundaries.  Perfectly-constant
    # lanes encode bit-identically as scalar x bitmask in ANY dtype; in
    # f32 performance mode near-constant lanes additionally demote their
    # non-modal entries (<= 5% of nnz) into the exact COO remainder ----
    nlanes = len(kept_sorted)
    modes = np.zeros(nlanes, dtype=np.float64)
    is_f32 = np.dtype(dtype) == np.float32
    demote = np.zeros(d.shape[0], dtype=bool)
    const_ok = nlanes > 0
    n_exc = 0
    # compare in the TARGET dtype: summation noise around a constant
    # weight (~1e-13 in f64 interpolation products) vanishes under the
    # f32 cast, so the performance mode sees the true constant structure
    data_cmp = P.data.astype(np.dtype(dtype))
    for li in range(nlanes):
        idx = np.flatnonzero(sel & (lane == li))
        if idx.size == 0:
            continue
        v, c = np.unique(data_cmp[idx], return_counts=True)
        modes[li] = v[c.argmax()]
        exc = idx[data_cmp[idx] != modes[li]]
        if exc.size:
            if is_f32:
                demote[exc] = True
                n_exc += int(exc.size)
            else:
                const_ok = False
    if is_f32 and n_exc > 0.05 * nnz:
        const_ok = False
        demote[:] = False
    const_mode = bool(const_ok)
    # byte-ratio rejection with the EFFECTIVE storage cost: bitmask
    # lanes cost nf/8 bytes, full lanes nf*itemsize
    eff_band_bytes = (nlanes * ((nf + 31) // 32) * 4 if const_mode
                      else nlanes * nf * itemsize)
    if eff_band_bytes > max_bytes_ratio * coo_bytes and nf > 4096:
        return None
    if is_f32 and const_mode:
        sel = sel & ~demote
    if const_mode:
        from ...ops.operators import pack_bits
        wm_np = np.zeros((nlanes, (nf + 31) // 32), dtype=np.int32)
        rowmask = np.zeros(nf, dtype=bool)
        for li in range(nlanes):
            rowmask[:] = False
            rowmask[rows[sel & (lane == li)]] = True
            wm_np[li] = pack_bits(rowmask)
        wc_np = modes.astype(np.dtype(dtype))
        w = np.zeros((nlanes, 1), dtype=np.dtype(dtype))   # dummy
    else:
        wc_np = wm_np = None
        w = np.zeros((nlanes, nf), dtype=np.dtype(dtype))
        # (row, shift) is unique because fpos is injective
        w[lane[sel], rows[sel]] = P.data[sel]
    # COO remainder (shared arrays between P and R, csr_transfer-style)
    n_rem = int((~sel).sum())
    has_rem = n_rem > 0
    pad_n = _round_up(max(n_rem, 1), 128)
    rr = np.full(pad_n, nf, dtype=np.int32)
    rc = np.full(pad_n, nc, dtype=np.int32)
    rv = np.zeros(pad_n, dtype=np.dtype(dtype))
    if has_rem:
        rr[:n_rem] = rows[~sel]
        rc[:n_rem] = cols[~sel]
        rv[:n_rem] = P.data[~sel]
    fpos_d = asdev(fpos.astype(np.int32))
    w_d = asdev(w)
    rr_d, rc_d, rv_d = asdev(rr), asdev(rc), asdev(rv)
    shifts = tuple(int(s) for s in kept_sorted)
    args = (fpos_d, w_d, rr_d, rc_d, rv_d)
    kw = dict(shifts=shifts, n_fine=nf, n_coarse=nc, has_rem=has_rem,
              const_mode=const_mode)
    if const_mode:
        kw["wc"] = asdev(wc_np)
        kw["wm"] = asdev(wm_np)
    return (BandedProlong(*args, **kw), BandedRestrict(*args, **kw))


def csr_transfer(P: CSRMatrix, dtype=None, share: bool = True):
    """General sparse prolongation + transpose restriction.

    ``share=True`` (default): one COO array set serves both directions
    (halves the transfer's device footprint; restriction pays an unsorted
    segment-sum).  ``share=False``: independent row-sorted ELL operators
    (reference: R = P^T, fasp_dcsr_trans)."""
    dtype = dtype or default_dtype()
    if not share:
        Pop = EllOperator.from_csr(P, dtype=dtype)
        Rop = EllOperator.from_csr(P.transpose(), dtype=dtype)
        return Pop, Rop
    from ...ops.operators import _round_up, asdev
    nf, nc = P.shape
    nnz = P.nnz
    pad = _round_up(max(nnz, 1), 128)
    rows = np.full(pad, nf, dtype=np.int32)
    cols = np.full(pad, nc, dtype=np.int32)
    vals = np.zeros(pad, dtype=np.dtype(dtype))
    rows[:nnz] = np.repeat(np.arange(nf, dtype=np.int32),
                           np.diff(P.indptr))
    cols[:nnz] = P.indices
    vals[:nnz] = P.data
    r, c, v = asdev(rows), asdev(cols), asdev(vals)
    return (CooProlong(r, c, v, nf, nc),
            CooRestrict(r, c, v, nf, nc))


def expand_compressed_transfer(t):
    """Materialize a const-mode banded transfer's scalar x bitmask lanes
    into a plain weight array (see ops.operators.expand_compressed: the
    per-apply unpack re-runs inside Krylov while_loops)."""
    import dataclasses as _dc
    if isinstance(t, (BandedProlong, BandedRestrict)) and t.const_mode:
        from ...ops.operators import unpack_bits
        w = jnp.stack([t.wc[k] * unpack_bits(t.wm[k], t.n_fine, t.dtype)
                       for k in range(len(t.shifts))])
        return _dc.replace(t, w=w, wc=None, wm=None, const_mode=False)
    return t
