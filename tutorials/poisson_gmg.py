"""Matrix-free geometric multigrid for the Poisson equation.

Reference: tutorial/main/poisson-gmg.c.
"""
import jax
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from faspsolver_tpu.precond import poisson_gmg_2d

n = 128                                   # (n+1)x(n+1) grid incl. boundary
h = 1.0 / n
xs = np.arange(n + 1) * h
X, Y = np.meshgrid(xs, xs)
f = 2 * np.pi**2 * np.sin(np.pi * X) * np.sin(np.pi * Y)
res = poisson_gmg_2d(jnp.asarray(f), n, tol=1e-9)
uex = np.sin(np.pi * X) * np.sin(np.pi * Y)
err = np.abs(np.asarray(res.x) - uex).max()
print(f"GMG: {int(res.iters)} cycles, relres {float(res.relres):.3e}, "
      f"max err vs exact {err:.3e}")
