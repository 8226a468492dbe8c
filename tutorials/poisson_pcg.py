"""AMG-preconditioned CG on the shipped FE Poisson system.

Reference: tutorial/main/poisson-pcg.c (+ ini/pcg.dat).
"""
import sys

import jax
jax.config.update("jax_enable_x64", True)

import numpy as np

from faspsolver_tpu.io import read_csrvec
from faspsolver_tpu.solvers import krylov_amg
from faspsolver_tpu.utils.params import ITSParam

data = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data"
A, b = read_csrvec(f"{data}/csrmat_FE.dat", f"{data}/rhs_FE.dat")
res, hierarchy = krylov_amg(A, b, its=ITSParam(tol=1e-10, maxit=200))
print(f"AMG-PCG: {int(res.iters)} iterations, relres {float(res.relres):.3e}")
