"""Pytree packing: freeze a host pytree as flat device buffers and
rebuild it with traced slices INSIDE the consuming jitted program.

Why this exists:
- each ``jax.device_put`` pays a fixed dispatch latency, and a hierarchy
  has ~70 leaves;
- an on-device split program (one concat upload + lax.slice program) is
  one more program to compile and load for every layout;
- a packed buffer needs NO extra program at all: the single h2d transfer
  is program-free, and the slicing happens inside the solver program the
  caller compiles (and warms) anyway.
Whether this still pays against the H100's host link is ROADMAP D2.

This is the device answer to the reference's single-arena AMG_data
allocation (PreDataInit.c): the whole hierarchy is one contiguous block,
and "pointers into the block" become static slice offsets baked into the
solve program.

Float leaves are cast to the requested solve dtype and packed into the
float buffer; integer leaves (ELL column indices, aggregation maps) are
cast to int32 and packed into a second buffer.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class PackedPytree:
    """A pytree whose array leaves live concatenated in flat device
    buffers (one float, one optional int32).

    ``unpack(buf_f, buf_i)`` rebuilds the tree; called inside a jitted
    function with the buffers as arguments, the leaves are fusion-friendly
    slices and the packed layout never costs its own XLA program.
    """

    buf_f: jax.Array                                 # flat float buffer
    buf_i: Optional[jax.Array]                       # flat int32 buffer
    treedef: Any
    # per unique array: (is_int, offset, size, shape)
    layout: Tuple[Tuple[bool, int, int, Tuple[int, ...]], ...]
    leaf_slot: Tuple[int, ...]                       # leaf -> layout index
    nbytes: int

    def unpack(self, buf_f: Optional[jax.Array] = None,
               buf_i: Optional[jax.Array] = None):
        buf_f = self.buf_f if buf_f is None else buf_f
        buf_i = self.buf_i if buf_i is None else buf_i
        devs = [
            jax.lax.slice(buf_i if is_int else buf_f, (o,),
                          (o + s,)).reshape(shp)
            for is_int, o, s, shp in self.layout]
        return jax.tree_util.tree_unflatten(
            self.treedef, [devs[i] for i in self.leaf_slot])

    @property
    def bufs(self):
        return (self.buf_f,) if self.buf_i is None else \
            (self.buf_f, self.buf_i)


def pack_pytree(tree, dtype) -> Optional[PackedPytree]:
    """Pack every array leaf of a HOST pytree into flat device buffers
    (floats cast to ``dtype``, ints to int32).  Returns None if any leaf
    is already a device array or not packable (callers fall back to a
    classic freeze)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    np_dtype = np.dtype(dtype)
    slot_of: dict = {}
    arrs = []          # (is_int, array)
    leaf_slot = []
    for l in leaves:
        if isinstance(l, jax.Array):
            return None
        key = id(l)
        if key not in slot_of:
            a = np.asarray(l)
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(np_dtype, copy=False)
                is_int = False
            elif np.issubdtype(a.dtype, np.integer):
                a = a.astype(np.int32, copy=False)
                is_int = True
            else:
                return None
            slot_of[key] = len(arrs)
            arrs.append((is_int, a))
        leaf_slot.append(slot_of[key])
    layout = []
    offs = {False: 0, True: 0}
    for is_int, a in arrs:
        layout.append((is_int, offs[is_int], int(a.size), tuple(a.shape)))
        offs[is_int] += int(a.size)
    f_parts = [a.ravel() for ii, a in arrs if not ii]
    i_parts = [a.ravel() for ii, a in arrs if ii]
    flat_f = np.concatenate(f_parts) if f_parts else \
        np.zeros(0, dtype=np_dtype)
    buf_f = jnp.asarray(flat_f)         # ONE program-free h2d transfer
    buf_i = None
    nbytes = flat_f.nbytes
    if i_parts:
        flat_i = np.concatenate(i_parts)
        buf_i = jnp.asarray(flat_i)
        nbytes += flat_i.nbytes
    return PackedPytree(buf_f=buf_f, buf_i=buf_i, treedef=treedef,
                        layout=tuple(layout), leaf_slot=tuple(leaf_slot),
                        nbytes=nbytes)


@dataclass(frozen=True)
class PackedHierarchy:
    """An AMG hierarchy frozen as packed buffers: ``p32`` holds the solve-
    precision hierarchy (fine64 field excluded), ``p64`` the optional f64
    fine operator for device-resident refinement."""

    p32: PackedPytree
    p64: Optional[PackedPytree]

    def unpack(self, bufs32=None, bufs64=None):
        """Rebuild the hierarchy; ``bufs32``/``bufs64`` are the buffer
        tuples (as produced by ``.p32.bufs`` / ``.p64.bufs``), defaulting
        to the stored ones."""
        hier = self.p32.unpack(*(bufs32 if bufs32 is not None else ()))
        if self.p64 is not None:
            hier = dataclasses.replace(
                hier,
                fine64=self.p64.unpack(
                    *(bufs64 if bufs64 is not None else ())))
        return hier

    def materialize(self):
        """Concrete device hierarchy via one jitted unpack (for eager
        consumers like SpMV micro-benchmarks; solvers should unpack inside
        their own program instead)."""
        fn = jax.jit(lambda b32, b64: self.unpack(b32, b64))
        return fn(self.p32.bufs,
                  self.p64.bufs if self.p64 is not None else ())
