"""AMG as a standalone solver on the shipped FE Poisson system.

Reference: tutorial/main/poisson-amg.c (+ ini/amg.dat).
Run: python tutorials/poisson_amg.py [path-to-data-dir]
"""
import sys

import jax
jax.config.update("jax_enable_x64", True)

import numpy as np

from faspsolver_tpu.io import read_csrvec
from faspsolver_tpu.solvers import solve_amg
from faspsolver_tpu.utils.params import AMGParam

data = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data"
A, b = read_csrvec(f"{data}/csrmat_FE.dat", f"{data}/rhs_FE.dat")
res = solve_amg(A, b, amg=AMGParam(maxit=100, tol=1e-9))
r = b - A.matvec(np.asarray(res.x))
print(f"AMG: {int(res.iters)} cycles, relres "
      f"{np.linalg.norm(r)/np.linalg.norm(b):.3e}")
