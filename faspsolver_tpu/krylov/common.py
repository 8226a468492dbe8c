"""Shared Krylov machinery: stopping criteria, safeguard constants.

Reference: base/src/KryUtil.inl (ITS_* macros) and the identical
safeguard blocks replicated in every Kry*.c file.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..constants import (MAX_RESTART, MAX_STAG, STAG_RATIO, StopType)
from .precond import IdentityPrecond

SMALLREAL = 1e-20       # reference SMALLREAL (fasp_const.h)
SMALLREAL2 = 1e-40      # reference SMALLREAL2: breakdown guard


def basis_dot(a, b):
    """Product with a Krylov basis in full f32/f64: a default-precision f32
    matmul may run in TF32 on a GPU."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def resolve_precond(M) -> Callable:
    return IdentityPrecond() if M is None else M


def residual_norms(stop_type: int, r, z, normr0, normu):
    """(absres, relres) for the three reference stopping criteria.

    stop_type is a Python int (static under jit): the switch resolves at
    trace time exactly like the reference's C switch.
    """
    if stop_type == StopType.REL_PRECRES:
        absres = jnp.sqrt(jnp.abs(jnp.dot(z, r)))
        return absres, absres / normr0
    absres = jnp.sqrt(jnp.dot(r, r))
    if stop_type == StopType.MOD_REL_RES:
        return absres, absres / normu
    return absres, absres / normr0


def initial_norms(stop_type: int, r, z, x):
    """(absres0, normr0, normu, relres) at iteration 0
    (reference: KryPcg.c:134-160)."""
    if stop_type == StopType.REL_PRECRES:
        absres0 = jnp.sqrt(jnp.abs(jnp.dot(z, r)))
        normr0 = jnp.maximum(SMALLREAL, absres0)
        normu = jnp.maximum(SMALLREAL, jnp.sqrt(jnp.dot(x, x)))
        return absres0, normr0, normu, absres0 / normr0
    absres0 = jnp.sqrt(jnp.dot(r, r))
    normr0 = jnp.maximum(SMALLREAL, absres0)
    normu = jnp.maximum(SMALLREAL, jnp.sqrt(jnp.dot(x, x)))
    if stop_type == StopType.MOD_REL_RES:
        return absres0, normr0, normu, absres0 / normu
    return absres0, normr0, normu, absres0 / normr0
