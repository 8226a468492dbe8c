"""Device operator for structured-grid banded block (STR) matrices.

Reference: dSTRmat (fasp.h:316-348) + fasp_blas_dstr_mxv (BlaSpmvSTR.c).
On the device the STR layout is the ideal one: each band is a dense
(ngrid, nc, nc) array, and SpMV is a sum of statically-shifted batched
block products — zero gathers, one einsum per band.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.str_grid import STRMatrix
from .operators import default_dtype


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class StrOperator:
    """Banded block operator: y_g = diag_g x_g + sum_b band_b[g] x_{g+off_b}."""

    diag: jax.Array                    # (ng, nc, nc)
    bands: Tuple[jax.Array, ...]       # each (ng, nc, nc)
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    ng: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.ng * self.nc
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    def __call__(self, x: jax.Array) -> jax.Array:
        ng, nc = self.ng, self.nc
        xb = x.reshape(ng, nc)
        hi = jax.lax.Precision.HIGHEST
        y = jnp.einsum("gab,gb->ga", self.diag, xb, precision=hi)
        for off, band in zip(self.offsets, self.bands):
            if off > 0:
                contrib = jnp.einsum("gab,gb->ga", band[:ng - off], xb[off:],
                                     precision=hi)
                y = y.at[:ng - off].add(contrib)
            else:
                k = -off
                contrib = jnp.einsum("gab,gb->ga", band[k:], xb[:ng - k],
                                     precision=hi)
                y = y.at[k:].add(contrib)
        return y.reshape(-1)

    def diag_inv(self) -> jax.Array:
        """(ng, nc, nc) batched inverse of the diagonal blocks — computed
        on host at setup in the reference (fasp_generate_diaginv_block)."""
        return jnp.asarray(np.linalg.inv(np.asarray(self.diag,
                                                    dtype=np.float64))
                           .astype(np.asarray(self.diag).dtype))

    @classmethod
    def from_str(cls, A: STRMatrix, dtype=None) -> "StrOperator":
        dtype = dtype or default_dtype()
        nd = np.dtype(dtype)
        return cls(diag=jnp.asarray(A.diag.astype(nd)),
                   bands=tuple(jnp.asarray(b.astype(nd)) for b in A.offdiag),
                   offsets=tuple(int(o) for o in A.offsets),
                   ng=A.ngrid, nc=A.nc)
