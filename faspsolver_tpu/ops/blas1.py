"""BLAS-1 vector primitives for the solve phase.

Reference: base/src/BlaArray.c / BlaVector.c (fasp_blas_darray_axpy /
dotprod / norm2 / ...).  On the device these are trivial jnp
expressions — the value here is (a) a stable naming layer mirroring the
reference API for parity audits, and (b) *fused* combinations that keep
Krylov inner loops to a minimal number of HBM passes (XLA fuses chains
of these into single kernels; the fused helpers document the intended
fusion groups).

Distributed note: under shard_map these same expressions work unchanged —
dot/norm reductions become psum collectives (see parallel/pcsr.py).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def axpy(a, x: jax.Array, y: jax.Array) -> jax.Array:
    """y + a*x (reference: fasp_blas_darray_axpy)."""
    return y + a * x


def axpby(a, x: jax.Array, b, y: jax.Array) -> jax.Array:
    """a*x + b*y (reference: fasp_blas_darray_axpby)."""
    return a * x + b * y


def dot(x: jax.Array, y: jax.Array) -> jax.Array:
    """<x, y> (reference: fasp_blas_darray_dotprod)."""
    return jnp.dot(x, y, preferred_element_type=x.dtype)


def norm2(x: jax.Array) -> jax.Array:
    """||x||_2 (reference: fasp_blas_darray_norm2)."""
    return jnp.sqrt(dot(x, x))


def norm1(x: jax.Array) -> jax.Array:
    """||x||_1 (reference: fasp_blas_darray_norm1)."""
    return jnp.sum(jnp.abs(x))


def norminf(x: jax.Array) -> jax.Array:
    """||x||_inf (reference: fasp_blas_darray_norminf)."""
    return jnp.max(jnp.abs(x))


def relerr(x: jax.Array, y: jax.Array) -> jax.Array:
    """||x-y|| / ||x|| (reference: fasp_blas_dvec_relerr)."""
    return norm2(x - y) / jnp.maximum(norm2(x), jnp.finfo(x.dtype).tiny)


# -- fused groups: one logical HBM pass each --------------------------------

def dot2(x: jax.Array, y: jax.Array, z: jax.Array
         ) -> Tuple[jax.Array, jax.Array]:
    """(<x,y>, <x,z>) — two dots sharing one read of x."""
    return dot(x, y), dot(x, z)


def axpy_dot(a, x: jax.Array, y: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """w = y + a*x and <w,w> fused."""
    w = y + a * x
    return w, dot(w, w)


def update_xr(x: jax.Array, r: jax.Array, alpha, p: jax.Array, Ap: jax.Array
              ) -> Tuple[jax.Array, jax.Array]:
    """CG inner update: x += alpha p; r -= alpha Ap (one fused pass)."""
    return x + alpha * p, r - alpha * Ap


def maxdiff(x: jax.Array, y: jax.Array) -> jax.Array:
    """Maximum absolute difference (reference: fasp_dvec_maxdiff,
    AuxVector.c)."""
    return jnp.max(jnp.abs(x - y))


def isnan(x: jax.Array) -> jax.Array:
    """Any-NaN check (reference: fasp_dvec_isnan, AuxVector.c)."""
    return jnp.any(jnp.isnan(x))
