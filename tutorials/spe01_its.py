"""BSR reservoir system (SPE01 black-oil Jacobian): vFGMRES + BSR-AMG.

Reference: tutorial/main/spe01-its.c (+ ini/its_bsr.dat).
"""
import sys

import jax
jax.config.update("jax_enable_x64", True)

import numpy as np

from faspsolver_tpu.io import read_bsr, read_vec
from faspsolver_tpu.solvers import krylov_amg
from faspsolver_tpu.constants import SolverType
from faspsolver_tpu.utils.params import ITSParam

data = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data"
A = read_bsr(f"{data}/bsrmat_SPE01.dat")
b = read_vec(f"{data}/rhs_SPE01.dat")
res, hierarchy = krylov_amg(
    A, b, its=ITSParam(itsolver_type=int(SolverType.VFGMRES),
                       tol=1e-9, maxit=500, restart=30))
r = b - A.matvec(np.asarray(res.x))
print(f"SPE01 vFGMRES+AMG: {int(res.iters)} iterations, relres "
      f"{np.linalg.norm(r)/np.linalg.norm(b):.3e}")
