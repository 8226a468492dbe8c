"""Host-side band (stencil) algebra for the structured AMG setup.

Everything the structured setup needs — operator products, smoothed-P
Galerkin triple products, pair-aggregation RAP, spectral bounds — expressed
directly on per-axis band coordinates, fully vectorized NumPy, O(k^2 n).
This replaces general sparse SpGEMM in the setup loop (the reference's
fasp_blas_dcsr_rap, BlaSpmvCSR.c:999, is the analogous specialized fused
triple product; here the stencil structure lets the product be computed
band-by-band with no symbolic pass at all).

A :class:`BandMatrix` stores bands keyed by per-axis coordinate offsets
(e.g. (dy, dx)), which makes the algebra exact: flat offsets are ambiguous
(a +1 flat offset could be an x-neighbor or a row-wrap), so construction
validates that every nonzero decomposes into small per-axis offsets and
refuses otherwise (callers then fall back to the general sparse path).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

Coord = Tuple[int, ...]


def _strides(dims: Tuple[int, ...]) -> Tuple[int, ...]:
    s = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        s[i] = s[i + 1] * dims[i + 1]
    return tuple(s)


@dataclass
class BandMatrix:
    """Square matrix on a structured index grid, stored as coordinate bands.

    ``bands[c][idx] = A[idx, idx + c]`` with idx an nd grid coordinate and
    c a per-axis offset tuple; positions where idx + c falls off the grid
    hold 0.
    """

    dims: Tuple[int, ...]
    bands: Dict[Coord, np.ndarray] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(np.prod(self.dims))

    # -- construction ------------------------------------------------------

    @classmethod
    def from_csr(cls, A, dims: Tuple[int, ...], max_c: int = 4,
                 dtype=None) -> Optional["BandMatrix"]:
        """Decompose a CSR matrix into coordinate bands; None if any entry
        does not fit the structure (wrap entries, long-range couplings).

        Per-band path: extract flat diagonals once (O(nnz)), then decompose
        each flat offset into axis coordinates and verify the band has no
        boundary-wrapping entries.
        """
        from ...ops.operators import dia_bands_from_csr

        n = int(np.prod(dims))
        if A.nrow != n or A.ncol != n:
            return None
        offsets, flat = dia_bands_from_csr(A)
        return cls.from_flat(offsets, flat, dims, max_c=max_c, dtype=dtype)

    @classmethod
    def from_flat(cls, offsets, flat, dims: Tuple[int, ...], max_c: int = 4,
                  dtype=None) -> Optional["BandMatrix"]:
        """Build from an already-extracted flat-diagonal representation
        (offsets + row-aligned (k, n) bands) — callers that have run
        dia_bands_from_csr for detection reuse it instead of re-extracting.
        Same wrap validation as from_csr."""
        st = _strides(dims)
        if dtype is not None:
            flat = flat.astype(np.dtype(dtype))
        out = cls(dims=tuple(dims))
        for k, o in enumerate(offsets):
            rem = int(o)
            coord = []
            for s in st[:-1]:
                c = int(np.rint(rem / s))
                coord.append(c)
                rem -= c * s
            coord.append(rem)
            if max(abs(c) for c in coord) > max_c:
                return None
            band = flat[k].reshape(dims)
            # validate: positions whose column coordinate falls off the
            # grid must hold zero — otherwise the flat offset was a wrap
            # (e.g. +1 from a row end) and the decomposition is wrong
            for ax, (c, d) in enumerate(zip(coord, dims)):
                if c == 0:
                    continue
                idx = [slice(None)] * len(dims)
                idx[ax] = slice(d - c, d) if c > 0 else slice(0, -c)
                if np.any(band[tuple(idx)]):
                    return None
            coord = tuple(coord)
            if coord in out.bands:
                out.bands[coord] = out.bands[coord] + band
            else:
                out.bands[coord] = band
        return out

    # -- exports -----------------------------------------------------------

    def flat_offsets(self) -> Tuple[np.ndarray, np.ndarray]:
        """(offsets, row-aligned (k, n) band array) for DiaOperator.

        Distinct nd coords can collide on one flat offset (e.g. (1,-2,0)
        and (0,3,0) on a 4x5x6 grid are both +18); per-axis validity
        zeroing guarantees at most one colliding band is nonzero at any
        position, so colliding bands are merged by summation — the flat
        (DIA) interpretation stays exact and offsets come out unique."""
        st = _strides(self.dims)
        merged: dict = {}
        for co, b in self.bands.items():
            o = sum(c * s for c, s in zip(co, st))
            if o in merged:
                merged[o] = merged[o] + b.reshape(-1)
            else:
                merged[o] = b.reshape(-1).copy()
        items = sorted(merged.items())
        offsets = np.array([o for o, _ in items], dtype=np.int64)
        flat = np.stack([v for _, v in items])
        return offsets, flat

    def to_csr(self):
        from ...formats import CSRMatrix
        import scipy.sparse as sp
        offsets, flat = self.flat_offsets()
        n = self.n
        rows_l, cols_l, vals_l = [], [], []
        for k, o in enumerate(offsets):
            o = int(o)
            idx = np.arange(max(0, -o), min(n, n - o))
            v = flat[k, idx]
            nz = v != 0.0
            rows_l.append(idx[nz])
            cols_l.append(idx[nz] + o)
            vals_l.append(v[nz])
        m = sp.csr_matrix((np.concatenate(vals_l),
                           (np.concatenate(rows_l), np.concatenate(cols_l))),
                          shape=(n, n))
        m.sum_duplicates()
        return CSRMatrix.from_scipy(m)

    def to_dense(self) -> np.ndarray:
        n = self.n
        out = np.zeros((n, n))
        offsets, flat = self.flat_offsets()
        for k, o in enumerate(offsets):
            o = int(o)
            idx = np.arange(max(0, -o), min(n, n - o))
            out[idx, idx + o] += flat[k, idx]
        return out

    def dtype(self):
        for b in self.bands.values():
            return b.dtype
        return np.dtype(np.float64)

    def diagonal(self) -> np.ndarray:
        z = tuple(0 for _ in self.dims)
        if z in self.bands:
            return self.bands[z].reshape(-1).copy()
        return np.zeros(self.n, dtype=self.dtype())

    def nnz(self) -> int:
        return sum(int(np.count_nonzero(b)) for b in self.bands.values())

    # -- algebra -----------------------------------------------------------

    def _stack(self) -> Tuple[np.ndarray, np.ndarray]:
        """(coords (k, nd) int32, bands (k, *dims)) for the native kernels."""
        items = sorted(self.bands.items())
        coords = np.asarray([c for c, _ in items], dtype=np.int32)
        stack = np.stack([b for _, b in items]) if items else \
            np.zeros((0,) + self.dims)
        return coords, stack

    @classmethod
    def _from_stack(cls, dims, coords, stack) -> "BandMatrix":
        out = cls(tuple(dims))
        for c, b in zip(coords, stack):
            if np.any(b):
                out.bands[tuple(int(x) for x in c)] = b
        return out

    def _shifted(self, band: np.ndarray, shift: Coord) -> np.ndarray:
        """out[idx] = band[idx + shift] (zero where out of range)."""
        out = np.zeros_like(band)
        src = []
        dst = []
        for ax, (s, d) in enumerate(zip(shift, self.dims)):
            if s >= 0:
                src.append(slice(s, d))
                dst.append(slice(0, d - s))
            else:
                src.append(slice(0, d + s))
                dst.append(slice(-s, d))
        out[tuple(dst)] = band[tuple(src)]
        return out

    def scale_rows(self, v: np.ndarray) -> "BandMatrix":
        """diag(v) @ A."""
        vg = v.reshape(self.dims)
        return BandMatrix(self.dims,
                          {c: vg * b for c, b in self.bands.items()})

    def scale_cols(self, v: np.ndarray) -> "BandMatrix":
        """A @ diag(v):  band[c][idx] *= v[idx + c]."""
        vg = v.reshape(self.dims)
        return BandMatrix(self.dims,
                          {c: b * self._shifted(vg, c)
                           for c, b in self.bands.items()})

    def add_identity(self, alpha: float = 1.0) -> "BandMatrix":
        out = {c: b.copy() for c, b in self.bands.items()}
        z = tuple(0 for _ in self.dims)
        if z in out:
            out[z] = out[z] + np.asarray(alpha, dtype=out[z].dtype)
        else:
            out[z] = np.full(self.dims, alpha, dtype=self.dtype())
        return BandMatrix(self.dims, out)

    def scaled(self, alpha: float) -> "BandMatrix":
        return BandMatrix(self.dims,
                          {c: alpha * b for c, b in self.bands.items()})

    def matmul(self, other: "BandMatrix") -> "BandMatrix":
        """C = self @ other:
        C[r, r+c1+c2] += self[r, r+c1] * other[r+c1, r+c1+c2].

        Fused slice form: the product is accumulated only on the index
        range where the shift is in-bounds — no shifted temporary, one
        pass per band pair.  2-D and 3-D grids route to the native OpenMP
        kernels (band_ops.cpp) when available.
        """
        if len(self.dims) in (2, 3) and self.bands and other.bands:
            from ... import native
            ca, sa = self._stack()
            cb, sb = other._stack()
            if sa.dtype == sb.dtype:
                fn = (native.band_matmul_2d if len(self.dims) == 2
                      else native.band_matmul_3d)
                nat = fn(self.dims, ca, sa, cb, sb)
                if nat is not None:
                    return BandMatrix._from_stack(self.dims, *nat)
        out: Dict[Coord, np.ndarray] = {}
        nd = len(self.dims)
        for c1, b1 in self.bands.items():
            dst = [None] * nd
            src = [None] * nd
            for ax, (s, d) in enumerate(zip(c1, self.dims)):
                if s >= 0:
                    dst[ax] = slice(0, d - s)
                    src[ax] = slice(s, d)
                else:
                    dst[ax] = slice(-s, d)
                    src[ax] = slice(0, d + s)
            dst_t, src_t = tuple(dst), tuple(src)
            for c2, b2 in other.bands.items():
                c = tuple(a + b for a, b in zip(c1, c2))
                acc = out.get(c)
                if acc is None:
                    acc = np.zeros(self.dims, dtype=b1.dtype)
                    out[c] = acc
                acc[dst_t] += b1[dst_t] * b2[src_t]
        out = {c: b for c, b in out.items() if np.any(b)}
        return BandMatrix(self.dims, out)

    def transpose(self) -> "BandMatrix":
        """B[r, r+c] = A[r+c, r]  ->  band_T[c][idx] = band[-c][idx + c]."""
        out = {}
        for c, b in self.bands.items():
            mc = tuple(-x for x in c)
            out[mc] = self._shifted(b, mc)
        return BandMatrix(self.dims, out)

    def pair_rap(self, ax: int, s: int = 2) -> "BandMatrix":
        """Exact Galerkin product P^T A P for boolean group aggregation
        along axis ``ax`` (aggregates {sJ..sJ+s-1}), directly in band
        space: a fine entry at rows sJ+a with axis-offset component c lands
        on coarse offset oc = (c + a - b)/s where b = (c + a) mod s.
        2-D and 3-D grids route to the native OpenMP kernels when
        available."""
        if len(self.dims) in (2, 3) and self.bands:
            from ... import native
            cf, stack = self._stack()
            fn = (native.pair_rap_2d if len(self.dims) == 2
                  else native.pair_rap_3d)
            nat = fn(self.dims, cf, stack, ax, s)
            if nat is not None:
                cc, C, cdims2 = nat
                return BandMatrix._from_stack(cdims2, cc, C)
        d = self.dims[ax]
        dc = (d + s - 1) // s
        cdims = list(self.dims)
        cdims[ax] = dc
        cdims = tuple(cdims)
        out: Dict[Coord, np.ndarray] = {}
        for c, band in self.bands.items():
            comp = c[ax]
            for a in range(s):
                bb = (comp + a) % s
                oc = (comp + a - bb) // s
                cc = list(c)
                cc[ax] = oc
                cc = tuple(cc)
                # dest[..., J, ...] += band[..., s*J + a, ...]
                nsrc = (d - a + s - 1) // s      # J with s*J + a < d
                if nsrc <= 0:
                    continue
                src = [slice(None)] * len(self.dims)
                src[ax] = slice(a, a + s * (nsrc - 1) + 1, s)
                dst = [slice(None)] * len(self.dims)
                dst[ax] = slice(0, nsrc)
                if cc not in out:
                    out[cc] = np.zeros(cdims, dtype=band.dtype)
                out[cc][tuple(dst)] += band[tuple(src)]
        out = {c: v for c, v in out.items() if np.any(v)}
        return BandMatrix(cdims, out)

    def to_nd_operator(self):
        """Grid-aware device operator (DiaNdOperator): per-axis shifted
        SpMV — axis-0 moves are whole-row moves (see
        tools/spmv_explore.py)."""
        import jax.numpy as jnp
        from ...ops.operators import DiaNdOperator
        coords, stack = self._stack()
        return DiaNdOperator(jnp.asarray(stack),
                             tuple(tuple(int(v) for v in c) for c in coords),
                             tuple(int(d) for d in self.dims))

    def to_stencil_operator(self, dtype=None, min_gain: float = 4.0):
        """Compressed grid-aware device operator (StencilNdOperator): each
        band is exactly factored by distinct-row/column grouping when that
        compresses it (constant-coefficient stencils collapse to a few
        scalars; Galerkin coarse bands to interior-constant + boundary
        rows), else kept dense.  Factorization is over (axis0, rest).

        The leaves stay HOST NumPy arrays — the caller's freeze moves them
        (matching to_nd_operator's contract).
        """
        from ...ops.operators import (FactoredBand, StencilNdOperator,
                                      factor_band_2d)
        items = sorted(self.bands.items())
        coords = tuple(tuple(int(v) for v in c) for c, _ in items)
        np_dtype = np.dtype(dtype) if dtype is not None else self.dtype()
        out = []
        for _, b in items:
            b = b.astype(np_dtype, copy=False)
            fac = factor_band_2d(b.reshape(b.shape[0], -1),
                                 min_gain=min_gain)
            if fac is not None:
                rs, core, cs = fac
                out.append(FactoredBand(rs, core, cs))
            else:
                out.append(b)
        return StencilNdOperator(tuple(out), coords,
                                 tuple(int(d) for d in self.dims))

    def smoothed_rap_all_axes(self, dinv: Optional[np.ndarray],
                              omega: float, s: int
                              ) -> Optional["BandMatrix"]:
        """Fused coarse Galerkin product
        ``P^T (I - w A D^-1) A (I - w D^-1 A) P`` with P the boolean
        s-per-axis grouping over every axis of extent > 1 (w=0: plain UA
        RAP) — ONE native tiled pass, no full-size intermediates.
        Returns None when the native kernel is unavailable (callers fall
        back to matmul + pair_rap, which is algebraically identical)."""
        if len(self.dims) not in (2, 3) or not self.bands:
            return None
        from ... import native
        coords, stack = self._stack()
        if dinv is None:
            dinv = np.ones(self.n, dtype=stack.dtype)
        out = native.smoothed_rap(self.dims, coords, stack,
                                  dinv.astype(stack.dtype, copy=False),
                                  float(omega), int(s))
        if out is None:
            return None
        cc, C, cdims = out
        return BandMatrix._from_stack(cdims, cc, C)

    def gershgorin_dinv_lambda(self) -> float:
        """Upper bound on lambda_max(D^-1 A): max_i dinv_i * sum_j |a_ij|."""
        d = self.diagonal()
        dinv = 1.0 / np.where(d != 0.0, d, 1.0)
        s = np.zeros(self.n)
        for b in self.bands.values():
            s += np.abs(b.reshape(-1))
        return float(np.max(np.abs(dinv) * s)) if self.n else 1.0
