"""The structured performance mode: structured SA-AMG + f32 + refinement.

This is the bench.py configuration as a tutorial: a gather-free structured
hierarchy in f32, inside an f64 refinement loop.  It runs on JAX's default
device.

Run: python tutorials/structured_refined.py [nx]
"""
import sys
import time

import numpy as np
import jax.numpy as jnp

from faspsolver_tpu.krylov import pcg
from faspsolver_tpu.precond import AMGPrecond
from faspsolver_tpu.precond.amg import setup_structured
from faspsolver_tpu.solvers import solve_refined
from faspsolver_tpu.testgen import poisson_2d
from faspsolver_tpu.utils.params import AMGParam
from faspsolver_tpu.constants import SmootherType

# size as CLI arg: 511 (261k dof) by default; pass 127 for a quick smoke
# run, 1023 for the 1M-dof bench problem
NX = int(sys.argv[1]) if len(sys.argv) > 1 else 511
A = poisson_2d(NX)
b = A.matvec(np.ones(A.nrow))

t0 = time.perf_counter()
hier = setup_structured(
    A, AMGParam(smoother=int(SmootherType.CHEBYSHEV), polynomial_degree=2,
                coarse_dof=800), dtype=jnp.float32, smooth_p=True)
print(f"setup {time.perf_counter()-t0:.2f}s, "
      f"levels {[l.A.shape[0] for l in hier.levels]}")

M = AMGPrecond(hier)
op = hier.levels[0].A

res = solve_refined(A, b, lambda r, tol: pcg(op, r, M=M, tol=tol, maxit=40),
                    tol=1e-8, dtype=jnp.float32)
print(f"refined solve: rounds={res.rounds} inner={res.inner_iters} "
      f"relres={res.relres:.3e}")
