"""Compare iterative solvers/preconditioners on one system.

Reference: tutorial/main/poisson-its.c (+ ini/its.dat).
"""
import sys

import jax
jax.config.update("jax_enable_x64", True)

from faspsolver_tpu.io import read_csrvec
from faspsolver_tpu import solvers
from faspsolver_tpu.constants import SolverType
from faspsolver_tpu.utils.params import ITSParam

data = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data"
A, b = read_csrvec(f"{data}/csrmat_FE.dat", f"{data}/rhs_FE.dat")
for name, run in [
    ("CG", lambda: solvers.krylov(A, b, its=ITSParam(tol=1e-8, maxit=2000))),
    ("CG+diag", lambda: solvers.krylov_diag(A, b, its=ITSParam(tol=1e-8, maxit=2000))),
    ("CG+ILU", lambda: solvers.krylov_ilu(A, b, its=ITSParam(tol=1e-8, maxit=500))),
    ("CG+AMG", lambda: solvers.krylov_amg(A, b, its=ITSParam(tol=1e-8, maxit=100))[0]),
    ("GMRES+AMG", lambda: solvers.krylov_amg(
        A, b, its=ITSParam(itsolver_type=int(SolverType.GMRES),
                           tol=1e-8, maxit=100, restart=30))[0]),
]:
    res = run()
    print(f"{name:10s}: iters={int(res.iters):5d} relres={float(res.relres):.3e}")
