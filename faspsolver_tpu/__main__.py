"""Ini-driven solver CLI — the reference's test driver as a module entry.

Reference: test/main/test.c (problem dispatch + solver/precond dispatch,
ini-configured) and the CLI flag set of fasp_param_set (AuxParam.c:41,
doc/userguide.tex:861).

Usage:
    python -m faspsolver_tpu -ini ini/input.dat
    python -m faspsolver_tpu -solver 1 -precond 2 -maxit 200 -tol 1e-8 \
        -mat data/csrmat_FE.dat -rhs data/rhs_FE.dat
    python -m faspsolver_tpu -problem poisson2d -size 255

Problems: explicit -mat/-rhs files, or generated (-problem poisson2d|
poisson3d|fe2d with -size N).
"""
from __future__ import annotations

import sys
import time

import numpy as np


def main(argv) -> int:
    import jax
    # the reference's arithmetic (REAL=double) on the default device; the
    # f32 + refinement mode is reached through solvers.solve_refined
    jax.config.update("jax_enable_x64", True)

    from .constants import PrecondType
    from .io import read_csrvec, read_mtx, read_vec
    from .solvers import (krylov, krylov_amg, krylov_diag, krylov_ilu,
                          krylov_swz)
    from .testgen import poisson_2d_manufactured, poisson_3d_manufactured, \
        poisson_fe_manufactured
    from .utils.params import apply_cli_overrides, param_init
    from .utils import messages

    # split off driver-only flags before the reference flag parser
    args = list(argv)
    extra = {}
    for key in ("-mat", "-rhs", "-problem", "-size"):
        if key in args:
            i = args.index(key)
            extra[key[1:]] = args[i + 1]
            del args[i:i + 2]

    inp = apply_cli_overrides(args)
    its, amg, ilu, swz = param_init(inp)

    # ---- problem ----------------------------------------------------------
    sol = None
    if "mat" in extra:
        if "rhs" in extra:
            if extra["mat"].endswith(".mtx"):
                A = read_mtx(extra["mat"])
                b = read_vec(extra["rhs"])
            else:
                A, b = read_csrvec(extra["mat"], extra["rhs"])
        else:
            A = read_mtx(extra["mat"]) if extra["mat"].endswith(".mtx") \
                else read_csrvec(extra["mat"], None)
            b = A.matvec(np.ones(A.nrow))
    else:
        size = int(extra.get("size", 64))
        prob = extra.get("problem", "poisson2d")
        if prob == "poisson3d":
            A, b, sol = poisson_3d_manufactured(size)
        elif prob == "fe2d":
            A, b, mesh, interior, uex = poisson_fe_manufactured(size)
            sol = None
        else:
            A, b, sol = poisson_2d_manufactured(size)

    messages.message(its.print_level, f"problem: n={A.nrow}, nnz={A.nnz}")

    # ---- solve ------------------------------------------------------------
    t0 = time.perf_counter()
    pt = int(inp.precond_type)
    if pt == PrecondType.NONE:
        res = krylov(A, b, its=its)
    elif pt == PrecondType.DIAG:
        res = krylov_diag(A, b, its=its)
    elif pt == PrecondType.ILU:
        res = krylov_ilu(A, b, its=its, ilu=ilu)
    elif pt == PrecondType.SCHWARZ:
        res = krylov_swz(A, b, its=its, swz=swz)
    else:
        res, _ = krylov_amg(A, b, its=its, amg=amg)
    wall = time.perf_counter() - t0

    x = np.asarray(res.x)
    r = b - A.matvec(x)
    relres = float(np.linalg.norm(r) / max(np.linalg.norm(b), 1e-300))
    print(f"Number of iterations = {int(res.iters)} with relative "
          f"residual {relres:.6e}.")
    print(f"Solver costs {wall:.4f} seconds.")
    if sol is not None:
        print(f"Max diff vs exact solution: {np.abs(x - sol).max():.6e}")
    return 0 if bool(res.converged) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
