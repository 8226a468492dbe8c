"""Explicit halo-exchange distributed DIA SpMV (shard_map + ppermute).

This is the performance distribution layer SURVEY.md §7 step 11 calls
for — the device redesign of a domain-decomposed MPI SpMV (which the
reference does not have; it is OpenMP-only, SURVEY §2.9):

- vectors and band arrays are ROW-BLOCK sharded over a 1-D mesh axis:
  shard i owns the contiguous flat-index slab [i*n_loc, (i+1)*n_loc);
- a banded SpMV with max offset magnitude ``h`` needs exactly the h
  entries on either side of the slab (the halo) — exchanged with the two
  neighbors via ``jax.lax.ppermute`` (lowers to a collective-permute
  between neighbouring devices, NOT an all-gather of the whole vector);
- communication/computation OVERLAP: the interior contribution (every
  term that only reads the local slab) is expressed independently of the
  received halos, so XLA's latency-hiding scheduler runs the big
  elementwise pass while the permutes are in flight; the halo terms
  touch only h elements per edge and are added at the end;
- Krylov reductions on the sharded outputs lower to psum via GSPMD —
  the solver loops run unchanged on globally-sharded arrays, only the
  operator apply is a shard_map region.

The coarse-grid analog of the reference's "gather to one rank and solve
serially" (PreMGCycle.c:156-202) stays in dist_dia.shard_hierarchy:
levels below a size threshold are replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats import CSRMatrix
from ..ops.operators import default_dtype, dia_bands_from_csr
from ..utils.messages import warn


@dataclasses.dataclass(frozen=True)
class CommMap:
    """Per-level communication plan, fixed at setup time.

    The reference's per-thread row partition (OpenMP static schedule) has
    no comm plan; the distributed analog records exactly what each SpMV
    will exchange so tests and tools can assert the pattern without
    lowering the program.
    """
    n_shards: int
    n_local: int                # rows per shard (padded-equal)
    halo: int                   # entries exchanged per neighbor edge
    replicated: bool = False    # True = no comm (coarse level)

    @property
    def bytes_per_exchange(self) -> int:
        if self.replicated:
            return 0
        return 2 * self.halo    # elements; x2 for both directions


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloDiaOperator:
    """Row-block sharded DIA operator with explicit neighbor exchange.

    ``bands`` is (k, n) sharded P(None, axis) over a 1-D mesh; ``x`` is
    expected sharded P(axis).  ``__call__`` runs a shard_map region that
    ppermutes the 2h halo entries and applies the bands locally.
    """

    bands: jax.Array            # (k, n), n = n_shards * n_local
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(default="rows",
                                  metadata=dict(static=True))
    # mesh is static config (hashable); jax Mesh is hashable
    mesh: Mesh = dataclasses.field(default=None,
                                   metadata=dict(static=True))

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def ncol(self):
        return self.n

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def halo(self) -> int:
        return max(max(abs(o) for o in self.offsets), 1)

    @property
    def comm_map(self) -> CommMap:
        ns = self.mesh.shape[self.axis]
        return CommMap(n_shards=ns, n_local=self.n // ns, halo=self.halo)

    def diagonal(self) -> jax.Array:
        for k, off in enumerate(self.offsets):
            if off == 0:
                return self.bands[k]
        return jnp.zeros(self.n, dtype=self.bands.dtype)

    # -- the shard-local kernel ---------------------------------------

    def _local_apply(self, bands_l: jax.Array, x_l: jax.Array) -> jax.Array:
        """Per-shard body: halo exchange + banded apply with overlap."""
        ax = self.axis
        h = self.halo
        n_loc = x_l.shape[0]
        ns = self.mesh.shape[ax]

        # neighbor exchange (devices at the ends receive zeros — exactly
        # the zero-halo the matrix boundary needs)
        send_right = [(i, i + 1) for i in range(ns - 1)]
        send_left = [(i, i - 1) for i in range(1, ns)]
        left_halo = jax.lax.ppermute(x_l[n_loc - h:], ax, send_right)
        right_halo = jax.lax.ppermute(x_l[:h], ax, send_left)

        # interior: every term reads ONLY the local slab (zero-filled at
        # the slab edges) — independent of the permutes, so XLA overlaps
        # this full-size pass with the exchange
        xp_local = jnp.pad(x_l, (h, h))
        y = jnp.zeros_like(x_l)
        for k, off in enumerate(self.offsets):
            y = y + bands_l[k] * jax.lax.slice(
                xp_local, (h + off,), (h + off + n_loc,))

        # halo corrections: off < 0 reads left of the slab -> the first
        # |off| rows are missing their left_halo contribution; off > 0
        # reads right -> last off rows missing right_halo.  Each touches
        # only h elements per edge.
        for k, off in enumerate(self.offsets):
            if off < 0:
                m = -off
                y = y.at[:m].add(bands_l[k][:m] * left_halo[h - m:])
            elif off > 0:
                y = y.at[n_loc - off:].add(
                    bands_l[k][n_loc - off:] * right_halo[:off])
        return y

    def __call__(self, x: jax.Array) -> jax.Array:
        fn = jax.shard_map(
            self._local_apply, mesh=self.mesh,
            in_specs=(P(None, self.axis), P(self.axis)),
            out_specs=P(self.axis))
        return fn(self.bands, x)


def halo_dia_operator(A: CSRMatrix, mesh: Mesh, dtype=None,
                      axis: str = "rows") -> HaloDiaOperator:
    """Build a halo-exchange sharded DIA operator from a host matrix.

    Rows are zero-padded to a shard multiple; requires the halo (max
    band offset) to fit within one shard — true for any realistic
    row-slab decomposition (h = grid row length, n_local >> h)."""
    dtype = dtype or default_dtype()
    offsets, bands = dia_bands_from_csr(A)
    n = A.nrow
    ns = mesh.shape[axis]
    target = ((n + ns - 1) // ns) * ns
    if target != n:
        bands = np.pad(bands, ((0, 0), (0, target - n)))
    h = max(int(np.max(np.abs(offsets))), 1)
    if h > target // ns:
        warn(f"halo {h} exceeds shard size {target // ns}; "
             "falling back to replicated DIA")
        from .dist_dia import dist_dia_operator
        return dist_dia_operator(A, mesh, dtype=dtype, axis=axis)
    dev = jax.device_put(jnp.asarray(bands.astype(np.dtype(dtype))),
                         NamedSharding(mesh, P(None, axis)))
    return HaloDiaOperator(dev, tuple(int(o) for o in offsets), target,
                           axis=axis, mesh=mesh)


def comm_pattern(op: HaloDiaOperator) -> str:
    """Lowered HLO for one SpMV — lets tests assert collective-permute
    (neighbor exchange) and the ABSENCE of all-gather."""
    x = jnp.zeros(op.n, dtype=op.dtype)
    x = jax.device_put(x, NamedSharding(op.mesh, P(op.axis)))
    return jax.jit(op.__call__).lower(x).compile().as_text()


def _flat_level_bands(op) -> Optional[Tuple[np.ndarray, Tuple[int, ...]]]:
    """Host (k, n) row-aligned flat bands + offsets for any banded level
    operator (Dia / DiaNd / compressed StencilNd).  Grid-shaped bands are
    re-zeroed at off-grid positions so the FLAT reinterpretation cannot
    wrap reads across grid rows (compressed stencil bands broadcast their
    interior constant into those positions; the Nd operator's padding
    kills them, a flat operator must store zeros)."""
    from ..ops.operators import (DiaNdOperator, DiaOperator, FactoredBand,
                                 StencilNdOperator)

    if isinstance(op, DiaOperator):
        return np.asarray(op.bands), op.offsets
    if isinstance(op, DiaNdOperator):
        return (np.asarray(op.bands).reshape(len(op.coords), -1),
                op.offsets)
    if isinstance(op, StencilNdOperator):
        dims = op.dims
        d0 = dims[0]
        rest = op.n // d0
        rows = []
        for co, b in zip(op.coords, op.bands):
            if isinstance(b, FactoredBand):
                m = np.asarray(b.row_sel) @ (np.asarray(b.core)
                                             @ np.asarray(b.col_sel))
                g = np.ascontiguousarray(
                    np.broadcast_to(m, (d0, rest))).reshape(dims).copy()
            else:
                g = np.asarray(b).reshape(dims).copy()
            for ax, (c, d) in enumerate(zip(co, dims)):
                if c == 0:
                    continue
                idx = [slice(None)] * len(dims)
                idx[ax] = slice(d - c, d) if c > 0 else slice(0, -c)
                g[tuple(idx)] = 0.0
            rows.append(g.reshape(-1))
        return np.stack(rows), op.offsets
    from ..ops.operators import ConstDiaOperator, SumOperator, \
        unpack_bits_np
    if isinstance(op, ConstDiaOperator):
        consts = np.asarray(op.consts)
        masks = np.asarray(op.masks)
        bands = np.stack([consts[k] * unpack_bits_np(masks[k], op.n)
                          for k in range(len(op.offsets))])
        return bands.astype(consts.dtype), op.offsets
    if isinstance(op, SumOperator):
        parts = [_flat_level_bands(p) for p in op.parts]
        if any(p is None for p in parts):
            return None
        bands = np.concatenate([b for b, _ in parts])
        offs = tuple(o for _, po in parts for o in po)
        return bands, offs
    return None


def halo_from_bands(offsets, bands: np.ndarray, mesh: Mesh, dtype=None,
                    axis: str = "rows") -> Optional[HaloDiaOperator]:
    """HaloDiaOperator from host flat bands (rows padded to a shard
    multiple); None if the halo does not fit within one shard."""
    dtype = dtype or bands.dtype
    k, n = bands.shape
    ns = mesh.shape[axis]
    target = ((n + ns - 1) // ns) * ns
    if target != n:
        bands = np.pad(bands, ((0, 0), (0, target - n)))
    h = max(int(np.max(np.abs(np.asarray(offsets)))), 1)
    if h > target // ns:
        return None
    dev = jax.device_put(jnp.asarray(bands.astype(np.dtype(dtype))),
                         NamedSharding(mesh, P(None, axis)))
    return HaloDiaOperator(dev, tuple(int(o) for o in offsets), target,
                           axis=axis, mesh=mesh)


def halo_shard_hierarchy(hier, mesh: Mesh, axis: str = "rows",
                         min_size: int = 4096):
    """PRODUCTION distributed placement of a structured AMG hierarchy:
    every level large enough gets an explicit halo-exchange
    :class:`HaloDiaOperator` (shard_map + ppermute, comm plan recorded in
    its CommMap); transfers/smoother arrays are row-block sharded under
    GSPMD; coarse levels replicate — the analog of the reference
    gathering the coarsest grid to one rank (PreMGCycle.c:156-202).

    Returns (hierarchy, comm_maps) with one CommMap per level
    (``replicated=True`` for replicated levels) — the per-level
    communication plan SURVEY §7 step 11 calls for.
    """
    import dataclasses as _dc

    from .dist_dia import shard_hierarchy

    placed = shard_hierarchy(hier, mesh, axis=axis, min_size=min_size)
    nsh = mesh.shape[axis]
    new_levels = []
    comm_maps = []
    for lvl, lvl_p in zip(hier.levels, placed.levels):
        n = lvl.A.shape[0]
        fb = _flat_level_bands(lvl.A)
        halo_op = None
        if fb is not None and n >= min_size and n % nsh == 0:
            halo_op = halo_from_bands(fb[1], fb[0], mesh,
                                      dtype=lvl.A.dtype, axis=axis)
        if halo_op is not None:
            new_lvl = _dc.replace(lvl_p, A=halo_op)
            # distributed banded transfers (general/RS path): the
            # fpos embed/extract of BandedProlong/Restrict is an
            # all-gather under GSPMD; the halo form exchanges only
            # adjacent shard blocks (see halo_banded_transfer)
            from ..precond.amg.transfer import BandedProlong
            if isinstance(lvl.P, BandedProlong):
                hb = halo_banded_transfer(lvl.P, mesh, axis)
                if hb is not None:
                    new_lvl = _dc.replace(new_lvl, P=hb[0], R=hb[1])
            new_levels.append(new_lvl)
            comm_maps.append(halo_op.comm_map)
        else:
            new_levels.append(lvl_p)
            comm_maps.append(CommMap(n_shards=nsh, n_local=n, halo=0,
                                     replicated=True))
    out = _dc.replace(placed, levels=tuple(new_levels))
    return out, tuple(comm_maps)


def cycle_comm_pattern(hier, mesh: Mesh, axis: str = "rows") -> str:
    """Lowered HLO of ONE FULL jitted multigrid cycle on the sharded
    hierarchy — lets tests assert the whole cycle's communication
    (collective-permute halo exchanges; no fine-level all-gather), not
    just a single SpMV's."""
    from ..precond.amg.cycles import mgcycle

    n = hier.levels[0].A.shape[0]
    r = jax.device_put(jnp.zeros(n, dtype=hier.levels[0].A.dtype),
                       NamedSharding(mesh, P(axis)))
    return jax.jit(lambda v: mgcycle(hier, v)).lower(r).compile().as_text()


def assert_neighbor_comm_only(hlo: str, fine_n: int) -> None:
    """Raise unless the HLO communicates by collective-permute and any
    all-gather is a coarse-level (small) one — the contract for the
    production distributed cycle."""
    import re

    if "collective-permute" not in hlo:
        raise AssertionError("no collective-permute in cycle HLO")
    for m in re.finditer(r"all-gather[^=]*\(", hlo):
        line_start = hlo.rfind("\n", 0, m.start()) + 1
        line = hlo[line_start:hlo.find("\n", m.start())]
        # size operands of ANY dtype (f32/f64/s32/u8/bf16/pred...): an
        # integer index array all-gather is as much a contract breach as
        # a float one
        shapes = re.findall(r"(?:f|s|u|bf|pred)\d*\[([\d,]*)\]", line)
        for s in shapes:
            elems = 1
            for d in filter(None, s.split(",")):
                elems *= int(d)
            if elems >= fine_n // 2:
                raise AssertionError(
                    f"fine-level-sized all-gather in cycle HLO: {line}")


# ---------------------------------------------------------------------------
# Distributed banded grid transfers (general/RS path).
#
# BandedProlong/BandedRestrict (precond/amg/transfer.py) pin coarse dof j
# to its C-point's fine position fpos[j], turning P into static fine-space
# shifts + an fpos embed/extract.  Under plain GSPMD the embed/extract is
# an arbitrary permutation -> a fine-level-sized all-gather.  But fpos is
# SORTED and C points are (near-)uniformly distributed, so the coarse
# entries any fine shard embeds — and the fine rows any coarse shard
# extracts — always live on the SAME or ADJACENT shards: the exchange is
# two neighbor collective-permutes of one shard block, exactly the halo
# pattern of the operator SpMV.  Indices are precomputed on host into
# static per-shard tables (CommMap-style plan, fixed at setup).
# ---------------------------------------------------------------------------


def _nbr_ext(x_l, ax, ns):
    """[left-neighbor block; local block; right-neighbor block] — ends
    receive zeros (the matrix boundary's zero halo)."""
    send_right = [(i, i + 1) for i in range(ns - 1)]
    send_left = [(i, i - 1) for i in range(1, ns)]
    from_left = jax.lax.ppermute(x_l, ax, send_right)
    from_right = jax.lax.ppermute(x_l, ax, send_left)
    return jnp.concatenate([from_left, x_l, from_right])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloBandedProlong:
    """y_f = P x_c with neighbor-only comm: per fine shard, ppermute the
    adjacent coarse blocks, embed the (host-planned) local C entries, and
    apply the fine-space shift bands from the local slab + halo."""

    w: jax.Array          # (k, nf) full band weights, sharded P(None, ax)
    emb_pos: jax.Array    # (ns, M) int32 local fine positions (pad -> B)
    emb_src: jax.Array    # (ns, M) int32 positions in the 3C ext block
    shifts: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    nf: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(default="rows",
                                  metadata=dict(static=True))
    mesh: Mesh = dataclasses.field(default=None,
                                   metadata=dict(static=True))

    @property
    def shape(self):
        return (self.nf, self.nc)

    @property
    def dtype(self):
        return self.w.dtype

    def _local(self, w_l, pos_l, src_l, xc_l):
        ax = self.axis
        ns = self.mesh.shape[ax]
        B = self.nf // ns
        xc_ext = _nbr_ext(xc_l, ax, ns)            # (3C,)
        vals = xc_ext[src_l[0]]                    # (M,) local gather
        xe_l = jnp.zeros(B + 1, xc_l.dtype).at[pos_l[0]].set(vals)[:B]
        # banded part: shifts read the embedded vector across shard
        # edges -> same halo exchange as the operator SpMV
        h = max(max((abs(s) for s in self.shifts), default=0), 1)
        send_right = [(i, i + 1) for i in range(ns - 1)]
        send_left = [(i, i - 1) for i in range(1, ns)]
        lh = jax.lax.ppermute(xe_l[B - h:], ax, send_right)
        rh = jax.lax.ppermute(xe_l[:h], ax, send_left)
        xp = jnp.concatenate([lh, xe_l, rh])       # (B + 2h,)
        y = jnp.zeros(B, xc_l.dtype)
        for k, s in enumerate(self.shifts):
            y = y + w_l[k] * jax.lax.slice(xp, (h + s,), (h + s + B,))
        return y

    def __call__(self, xc: jax.Array) -> jax.Array:
        fn = jax.shard_map(
            self._local, mesh=self.mesh,
            in_specs=(P(None, self.axis), P(self.axis), P(self.axis),
                      P(self.axis)),
            out_specs=P(self.axis))
        return fn(self.w, self.emb_pos, self.emb_src, xc)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloBandedRestrict:
    """y_c = P^T x_f off the same banded data: per-shard shifted
    accumulation (with x halo), then each coarse shard extracts its
    entries from the local + neighbor fine blocks."""

    w: jax.Array          # (k, nf) sharded P(None, ax)
    ext_src: jax.Array    # (ns, C) int32 positions in the 3B ext block
    shifts: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    nf: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(default="rows",
                                  metadata=dict(static=True))
    mesh: Mesh = dataclasses.field(default=None,
                                   metadata=dict(static=True))

    @property
    def shape(self):
        return (self.nc, self.nf)

    @property
    def dtype(self):
        return self.w.dtype

    def _local(self, w_l, src_l, xf_l):
        ax = self.axis
        ns = self.mesh.shape[ax]
        B = self.nf // ns
        h = max(max((abs(s) for s in self.shifts), default=0), 1)
        send_right = [(i, i + 1) for i in range(ns - 1)]
        send_left = [(i, i - 1) for i in range(1, ns)]
        # ye[i] = sum_k w[k][i - s_k] * xf[i - s_k]: each term needs
        # t = w*xf shifted INTO the slab, so exchange t's edges
        t_edges_l = []
        ye = jnp.zeros(B, xf_l.dtype)
        tall = []
        for k, s in enumerate(self.shifts):
            tall.append(w_l[k] * xf_l)
        tcat = jnp.stack(tall) if tall else jnp.zeros((0, B), xf_l.dtype)
        lh = jax.lax.ppermute(tcat[:, B - h:], ax, send_right)
        rh = jax.lax.ppermute(tcat[:, :h], ax, send_left)
        for k, s in enumerate(self.shifts):
            tp = jnp.concatenate([lh[k], tcat[k], rh[k]])
            ye = ye + jax.lax.slice(tp, (h - s,), (h - s + B,))
        ye_ext = _nbr_ext(ye, ax, ns)              # (3B,)
        return ye_ext[src_l[0]]                    # (C,) local gather

    def __call__(self, xf: jax.Array) -> jax.Array:
        fn = jax.shard_map(
            self._local, mesh=self.mesh,
            in_specs=(P(None, self.axis), P(self.axis), P(self.axis)),
            out_specs=P(self.axis))
        return fn(self.w, self.ext_src, xf)


def halo_banded_transfer(bp, mesh: Mesh, axis: str = "rows"):
    """Build (HaloBandedProlong, HaloBandedRestrict) from a
    :class:`~...precond.amg.transfer.BandedProlong` (remainder-free), or
    None when the plan would need non-neighbor exchange (C points not
    near-uniform) or shapes don't shard evenly."""
    import numpy as _np

    ns = mesh.shape[axis]
    nf, nc = bp.n_fine, bp.n_coarse
    if bp.has_rem or nf % ns or nc % ns:
        return None
    B, C = nf // ns, nc // ns
    fpos = _np.asarray(bp.fpos).astype(_np.int64)
    if _np.any(_np.diff(fpos) <= 0):
        return None                        # plan needs sorted C pins
    # per fine-shard embed plan
    jlo = _np.searchsorted(fpos, _np.arange(ns) * B, side="left")
    jhi = _np.searchsorted(fpos, (_np.arange(ns) + 1) * B, side="left")
    M = int((jhi - jlo).max())
    emb_pos = _np.full((ns, M), B, dtype=_np.int32)     # pad -> dropped
    emb_src = _np.zeros((ns, M), dtype=_np.int32)
    for s in range(ns):
        j = _np.arange(jlo[s], jhi[s])
        src = j - (s - 1) * C
        if src.size and (src.min() < 0 or src.max() >= 3 * C):
            return None                    # needs non-neighbor coarse data
        emb_pos[s, : j.size] = (fpos[j] - s * B).astype(_np.int32)
        emb_src[s, : j.size] = src.astype(_np.int32)
    # per coarse-shard extract plan
    ext_src = _np.zeros((ns, C), dtype=_np.int32)
    for t in range(ns):
        j = _np.arange(t * C, (t + 1) * C)
        src = fpos[j] - (t - 1) * B
        if src.size and (src.min() < 0 or src.max() >= 3 * B):
            return None                    # needs non-neighbor fine data
        ext_src[t] = src.astype(_np.int32)
    # full band weights (materialize const lanes; same bytes as the
    # operator's own bands)
    if bp.const_mode:
        from ..ops.operators import unpack_bits_np
        w = _np.stack([_np.asarray(bp.wc)[k]
                       * unpack_bits_np(_np.asarray(bp.wm)[k], nf)
                       for k in range(len(bp.shifts))])
        w = w.astype(_np.asarray(bp.wc).dtype)
    else:
        w = _np.asarray(bp.w)
    shb = NamedSharding(mesh, P(None, axis))
    shr = NamedSharding(mesh, P(axis))
    w_d = jax.device_put(jnp.asarray(w), shb)
    args = dict(shifts=tuple(bp.shifts), nf=nf, nc=nc, axis=axis,
                mesh=mesh)
    pro = HaloBandedProlong(
        w=w_d, emb_pos=jax.device_put(jnp.asarray(emb_pos), shr),
        emb_src=jax.device_put(jnp.asarray(emb_src), shr), **args)
    res = HaloBandedRestrict(
        w=w_d, ext_src=jax.device_put(jnp.asarray(ext_src), shr), **args)
    return pro, res
