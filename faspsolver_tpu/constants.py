"""Solver / preconditioner / AMG enumerations and status codes.

Re-design of the constant vocabulary of the reference FASP library
(reference: base/include/fasp_const.h).  Values are kept numerically identical
to the reference where a numeric id is part of the user-facing config surface
(ini files use the same integer codes), so ini files written for the reference
work unchanged.
"""
from __future__ import annotations

import enum


class SolverType(enum.IntEnum):
    """Iterative solver ids (reference: fasp_const.h:101-127)."""

    CG = 1
    BICGSTAB = 2
    MINRES = 3
    GMRES = 4
    VGMRES = 5
    VFGMRES = 6
    GCG = 7
    GCR = 8
    SCG = 11          # safety-net variants
    SBICGSTAB = 12
    SMINRES = 13
    SGMRES = 14
    SVGMRES = 15
    SVFGMRES = 16
    SGCG = 17
    AMG = 21
    FMG = 22
    SUPERLU = 31      # direct solvers (dense device path)
    UMFPACK = 32
    MUMPS = 33
    PARDISO = 34
    STRUMPACK = 35


class PrecondType(enum.IntEnum):
    """Preconditioner ids (reference: fasp_const.h:139-151 region)."""

    NONE = 0
    DIAG = 1
    AMG = 2
    FMG = 3
    ILU = 4
    SCHWARZ = 5


class StopType(enum.IntEnum):
    """Krylov stopping criteria (reference: fasp_const.h:132-134)."""

    REL_RES = 1        # ||r||_2 / ||b||_2
    REL_PRECRES = 2    # sqrt(r'Br) / sqrt(b'Bb)  (B = preconditioner)
    MOD_REL_RES = 3    # ||r||_2 / ||x||_2


class AMGType(enum.IntEnum):
    """AMG flavours (reference: fasp_const.h:161-165)."""

    CLASSIC = 1        # Ruge-Stuben
    SA = 2             # smoothed aggregation
    UA = 3             # unsmoothed aggregation


class AggregationType(enum.IntEnum):
    """Aggregation algorithms (reference: fasp_const.h:170-174)."""

    PAIRWISE = 1
    VMB = 2
    NPAIR = 3          # non-symmetric pairwise


class CycleType(enum.IntEnum):
    """Multigrid cycle types (reference: fasp_const.h:179-184)."""

    V = 1
    W = 2
    AMLI = 3
    NL_AMLI = 4
    VW = 12            # hybrid V-W
    WV = 21            # hybrid W-V


class SmootherType(enum.IntEnum):
    """Smoother ids (reference: fasp_const.h:189-208)."""

    JACOBI = 1
    GS = 2
    SGS = 3
    CG = 4
    SOR = 5
    SSOR = 6
    GSOR = 7
    SGSOR = 8
    POLY = 9
    L1DIAG = 10
    JACOBIF = 11        # Jacobi on fine points only
    GSF = 12            # GS on fine points only
    CHEBYSHEV = 13      # addition: fused Chebyshev polynomial
    RBGS = 14           # exact red-black GS via parity masks (structured
                        # path; reference: ItrSmootherRBGS.inl / PreGMG.inl
                        # gs2d_2color — the only natively-parallel GS there)
    # reservoir-simulator smoother ids (reference: fasp_const.h:204-208).
    # The reference only PARSES these in-tree (AuxInput.c:652-658) — the
    # implementations live in its closed reservoir apps — so here they
    # are accepted for ini compatibility and mapped to GS with a warning.
    BLKOIL = 21
    SPETEN = 22
    CPRGS = 23
    CPTRGS = 24


class CoarseningType(enum.IntEnum):
    """Classical AMG coarsening (reference: fasp_const.h:213-217)."""

    RS = 1             # modified Ruge-Stuben
    RSP = 2            # RS for positive off-diagonals
    CR = 3             # compatible relaxation
    AGGRESSIVE = 4
    MIS = 5            # maximal-independent-set based (parallel)


class InterpType(enum.IntEnum):
    """Interpolation operators (reference: fasp_const.h:222-226)."""

    DIRECT = 1
    STANDARD = 2
    ENERGYMIN = 3
    EXTENDED = 4


class ILUType(enum.IntEnum):
    """ILU variants (reference: fasp_const.h:149-151)."""

    ILUK = 1
    ILUT = 2
    ILUTP = 3


class SchwarzType(enum.IntEnum):
    """Schwarz sweep direction (reference: fasp_const.h Schwarz block)."""

    FORWARD = 1
    BACKWARD = 2
    SYMMETRIC = 3


class PrintLevel(enum.IntEnum):
    """Output verbosity (reference: fasp_const.h:73-78)."""

    NONE = 0
    MIN = 1
    SOME = 2
    MORE = 3
    MOST = 4
    ALL = 8


# C/F splitting vertex markers (reference: fasp_const.h:231-235)
FGPT = 0      # fine grid point
CGPT = 1      # coarse grid point
ISPT = 2      # isolated point
UNPT = -1     # undecided point

# Hierarchy limits (reference: fasp_const.h:258-262)
MAX_AMG_LVL = 20
MIN_CDOF = 20          # minimum coarse dof
OPENMP_HOLDS = 2000    # kept for config parity; device code always vectorizes

# Solver status codes (reference: fasp_const.h:41-68)
SUCCESS = 0
ERROR_OPEN_FILE = -10
ERROR_WRONG_FILE = -11
ERROR_INPUT_PAR = -13
ERROR_MAT_SIZE = -15
ERROR_MISC = -19
ERROR_ALLOC_MEM = -20
ERROR_DATA_STRUCTURE = -23
ERROR_DATA_ZERODIAG = -24
ERROR_DUMMY_VAR = -25
ERROR_AMG_INTERP_TYPE = -30
ERROR_AMG_SMOOTH_TYPE = -31
ERROR_AMG_COARSE_TYPE = -32
ERROR_AMG_COARSEING = -33
ERROR_AMG_SETUP = -39
ERROR_SOLVER_TYPE = -40
ERROR_SOLVER_PRECTYPE = -41
ERROR_SOLVER_STAG = -42
ERROR_SOLVER_SOLSTAG = -43
ERROR_SOLVER_TOLSMALL = -44
ERROR_SOLVER_ILUSETUP = -45
ERROR_SOLVER_MAXIT = -48
ERROR_SOLVER_EXIT = -49
ERROR_SOLVER_MISC = -50
ERROR_QUAD_TYPE = -60
ERROR_QUAD_DIM = -61
ERROR_UNKNOWN = -99

# Krylov safeguard tuning (reference: KryPcg.c preamble constants)
MAX_STAG = 20          # max stagnation restarts before bail
MAX_RESTART = 20       # max residual-recompute restarts
STAG_RATIO = 1e-4      # stagnation detection: ||d|| / ||x|| threshold scale
BIG_REAL = 1e28
SMALL_REAL = 1e-28
