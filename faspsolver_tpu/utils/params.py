"""Parameter system: dataclass defaults + ini-file parsing + CLI overrides.

Re-design of the reference three-layer config system
(reference: base/src/AuxParam.c, base/src/AuxInput.c):

1. programmatic defaults  -> dataclass field defaults (``AMGParam()``, ...)
2. ini file               -> :func:`parse_ini` reads the exact
   ``key = value % comment`` format the reference uses (test/ini/input.dat),
   including enum-by-name values (``AMG_type = SA``, ``AMG_smoother = GS``,
   ``AMG_coarse_scaling = OFF``)
3. CLI overrides          -> :func:`apply_cli_overrides` handles the
   ``-ini/-print/-solver/-itmaxit/-tol/...`` flags
   (reference: doc/userguide.tex:861, AuxParam.c:41 fasp_param_set)

``param_init`` fans the flat :class:`InputParam` out into per-subsystem
parameter objects (reference: AuxParam.c:306 fasp_param_init).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..constants import (
    AMGType, AggregationType, CoarseningType, CycleType, ILUType, InterpType,
    PrecondType, PrintLevel, SchwarzType, SmootherType, SolverType, StopType,
    ERROR_INPUT_PAR,
)
from .errors import FaspError


# ---------------------------------------------------------------------------
# Per-subsystem parameter dataclasses
# ---------------------------------------------------------------------------

@dataclass
class ITSParam:
    """Krylov iterative-solver parameters (reference: fasp.h itsolver_param)."""

    itsolver_type: int = int(SolverType.CG)
    precond_type: int = int(PrecondType.AMG)
    stop_type: int = int(StopType.REL_RES)
    maxit: int = 500
    tol: float = 1e-6
    abstol: float = 1e-18
    restart: int = 25
    print_level: int = int(PrintLevel.NONE)


@dataclass
class AMGParam:
    """AMG parameters (reference: fasp.h AMG_param; defaults AuxParam.c:431)."""

    AMG_type: int = int(AMGType.CLASSIC)
    print_level: int = int(PrintLevel.NONE)
    maxit: int = 1
    tol: float = 1e-6
    max_levels: int = 20
    coarse_dof: int = 500
    cycle_type: int = int(CycleType.V)
    smoother: int = int(SmootherType.GS)
    smooth_order: int = 1          # 0 = natural, 1 = C/F order
    presmooth_iter: int = 1
    postsmooth_iter: int = 1
    coarse_solver: int = 0
    relaxation: float = 1.0
    polynomial_degree: int = 3
    coarse_scaling: bool = False
    amli_degree: int = 2
    amli_coef: Optional[Tuple[float, ...]] = None
    nl_amli_krylov_type: int = int(SolverType.GCG)

    # classical AMG
    coarsening_type: int = int(CoarseningType.RS)
    interpolation_type: int = int(InterpType.DIRECT)
    max_row_sum: float = 0.9
    strong_threshold: float = 0.3
    truncation_threshold: float = 0.2
    aggressive_level: int = 0
    aggressive_path: int = 1

    # aggregation AMG
    aggregation_type: int = int(AggregationType.PAIRWISE)
    quality_bound: float = 10.0
    pair_number: int = 2
    strong_coupled: float = 0.08
    max_aggregation: int = 20
    tentative_smooth: float = 0.67
    smooth_filter: bool = True
    smooth_restriction: bool = True
    aggregation_norm_type: int = -1

    # ILU smoother
    ILU_type: int = int(ILUType.ILUK)
    ILU_levels: int = 0
    ILU_lfil: int = 0
    ILU_droptol: float = 0.001
    ILU_relax: float = 0.0
    ILU_permtol: float = 0.0

    # Schwarz smoother
    SWZ_levels: int = 0
    SWZ_mmsize: int = 200
    SWZ_maxlvl: int = 3
    SWZ_type: int = int(SchwarzType.FORWARD)
    SWZ_blksolver: int = 0

    theta: float = -1.0


@dataclass
class ILUParam:
    """ILU preconditioner parameters (reference: fasp.h ILU_param)."""

    print_level: int = int(PrintLevel.NONE)
    ILU_type: int = int(ILUType.ILUK)
    ILU_lfil: int = 0
    ILU_droptol: float = 0.001
    ILU_relax: float = 0.0
    ILU_permtol: float = 0.01   # reference: fasp_param_ilu_init, AuxParam.c:602


@dataclass
class SWZParam:
    """Schwarz preconditioner parameters (reference: fasp.h SWZ_param)."""

    print_level: int = int(PrintLevel.NONE)
    SWZ_type: int = int(SchwarzType.FORWARD)
    SWZ_maxlvl: int = 2
    SWZ_mmsize: int = 200
    SWZ_blksolver: int = 0


@dataclass
class InputParam:
    """Flat union of all ini-configurable keys (reference: fasp.h input_param)."""

    workdir: str = "../data/"
    print_level: int = int(PrintLevel.SOME)
    output_type: int = 0
    problem_num: int = 10
    solver_type: int = int(SolverType.CG)
    decoup_type: int = 1
    precond_type: int = int(PrecondType.AMG)
    stop_type: int = int(StopType.REL_RES)

    itsolver_tol: float = 1e-6
    itsolver_abstol: float = 1e-18
    itsolver_maxit: int = 500
    itsolver_restart: int = 25

    ILU_type: int = int(ILUType.ILUK)
    ILU_lfil: int = 0
    ILU_droptol: float = 0.001
    ILU_relax: float = 0.0
    ILU_permtol: float = 0.0

    SWZ_mmsize: int = 200
    SWZ_maxlvl: int = 2
    SWZ_type: int = 1
    SWZ_blksolver: int = 0

    AMG_type: int = int(AMGType.CLASSIC)
    AMG_levels: int = 20
    AMG_cycle_type: int = int(CycleType.V)
    AMG_smoother: int = int(SmootherType.GS)
    AMG_smooth_order: int = 1
    AMG_presmooth_iter: int = 1
    AMG_postsmooth_iter: int = 1
    AMG_relaxation: float = 1.0
    AMG_polynomial_degree: int = 3
    AMG_coarse_dof: int = 500
    AMG_coarse_solver: int = 0
    AMG_tol: float = 1e-6
    AMG_maxit: int = 1
    AMG_ILU_levels: int = 0
    AMG_SWZ_levels: int = 0
    AMG_coarse_scaling: bool = False
    AMG_amli_degree: int = 1
    AMG_nl_amli_krylov_type: int = 2

    AMG_coarsening_type: int = 1
    AMG_interpolation_type: int = 1
    AMG_max_row_sum: float = 0.9
    AMG_strong_threshold: float = 0.3
    AMG_truncation_threshold: float = 0.4
    AMG_aggressive_level: int = 0
    AMG_aggressive_path: int = 1

    AMG_aggregation_type: int = int(AggregationType.PAIRWISE)
    AMG_quality_bound: float = 8.0
    AMG_pair_number: int = 2
    AMG_strong_coupled: float = 0.25
    AMG_max_aggregation: int = 9
    AMG_tentative_smooth: float = 0.67
    AMG_smooth_filter: bool = True
    AMG_smooth_restriction: bool = True


# ---------------------------------------------------------------------------
# ini parsing
# ---------------------------------------------------------------------------

# string-valued enums accepted by the reference parser (AuxInput.c:86+);
# matching is case-insensitive.
_NAMED_VALUES = {
    "AMG_type": {"c": int(AMGType.CLASSIC), "sa": int(AMGType.SA),
                 "ua": int(AMGType.UA)},
    "AMG_cycle_type": {"v": int(CycleType.V), "w": int(CycleType.W),
                       "a": int(CycleType.AMLI), "na": int(CycleType.NL_AMLI),
                       "vw": int(CycleType.VW), "wv": int(CycleType.WV)},
    "AMG_smoother": {"jacobi": int(SmootherType.JACOBI),
                     "jacobif": int(SmootherType.JACOBIF),
                     "gs": int(SmootherType.GS),
                     "gsf": int(SmootherType.GSF),
                     "sgs": int(SmootherType.SGS),
                     "cg": int(SmootherType.CG),
                     "sor": int(SmootherType.SOR),
                     "ssor": int(SmootherType.SSOR),
                     "gsor": int(SmootherType.GSOR),
                     "sgsor": int(SmootherType.SGSOR),
                     "poly": int(SmootherType.POLY),
                     "l1diag": int(SmootherType.L1DIAG),
                     "cheby": int(SmootherType.CHEBYSHEV),
                     # reservoir names (AuxInput.c:652-658): accepted for
                     # ini-surface compatibility, mapped at build time
                     "blkoil": int(SmootherType.BLKOIL),
                     "speten": int(SmootherType.SPETEN),
                     "cprgs": int(SmootherType.CPRGS),
                     "cptrgs": int(SmootherType.CPTRGS)},
    "AMG_smooth_order": {"no": 0, "cf": 1},
}

_BOOL_KEYS = {"AMG_coarse_scaling", "AMG_smooth_filter", "AMG_smooth_restriction"}


def _coerce(key: str, raw: str, fields: dict):
    low = raw.lower()
    if key in _NAMED_VALUES and low in _NAMED_VALUES[key]:
        return _NAMED_VALUES[key][low]
    if key in _BOOL_KEYS or low in ("on", "off"):
        return low == "on"
    ftype = fields[key].type if key in fields else None
    if ftype in ("int", int):
        return int(raw)
    if ftype in ("float", float):
        return float(raw)
    if ftype in ("bool", bool):
        return low == "on" or low == "true" or raw == "1"
    if ftype in ("str", str):
        return raw
    # untyped fallback: best-effort numeric
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            return raw


def parse_ini(path: str, base: Optional[InputParam] = None) -> InputParam:
    """Read a reference-format ini file: ``key = value  % comment`` lines.

    Unknown keys raise (matching the strictness of fasp_param_input +
    fasp_param_check, reference AuxInput.c:33-80).
    """
    param = dataclasses.replace(base) if base is not None else InputParam()
    fields = {f.name: f for f in dataclasses.fields(InputParam)}
    with open(path, "r") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.split("%", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise FaspError(ERROR_INPUT_PAR,
                                f"{path}:{lineno}: expected 'key = value'")
            key, raw = (s.strip() for s in line.split("=", 1))
            if key not in fields:
                raise FaspError(ERROR_INPUT_PAR,
                                f"{path}:{lineno}: unknown key {key!r}")
            setattr(param, key, _coerce(key, raw, fields))
    check_param(param)
    return param


def check_param(param: InputParam) -> None:
    """Range-validate (reference: AuxInput.c:33 fasp_param_check)."""
    if param.problem_num < 0:
        raise FaspError(ERROR_INPUT_PAR, "problem_num must be non-negative")
    if param.itsolver_tol <= 0 or param.itsolver_maxit <= 0:
        raise FaspError(ERROR_INPUT_PAR, "bad itsolver tol/maxit")
    if not (0.0 < param.AMG_strong_threshold <= 1.0):
        raise FaspError(ERROR_INPUT_PAR, "AMG_strong_threshold out of (0,1]")
    if param.AMG_levels < 1 or param.AMG_coarse_dof < 1:
        raise FaspError(ERROR_INPUT_PAR, "bad AMG hierarchy limits")


# ---------------------------------------------------------------------------
# CLI overrides
# ---------------------------------------------------------------------------

_CLI_FLAGS = {
    "-print": ("print_level", int),
    "-output": ("output_type", int),
    "-solver": ("solver_type", int),
    "-precond": ("precond_type", int),
    "-maxit": ("itsolver_maxit", int),
    "-itmaxit": ("itsolver_maxit", int),
    "-tol": ("itsolver_tol", float),
    "-itstol": ("itsolver_tol", float),
    "-amgmaxit": ("AMG_maxit", int),
    "-amgtol": ("AMG_tol", float),
    "-amgtype": ("AMG_type", int),
    "-amgcycle": ("AMG_cycle_type", int),
    "-amgcoarsening": ("AMG_coarsening_type", int),
    "-amginterplation": ("AMG_interpolation_type", int),
    "-amgsmoother": ("AMG_smoother", int),
    "-amgsthreshold": ("AMG_strong_threshold", float),
    "-amgscouple": ("AMG_strong_coupled", float),
}


def apply_cli_overrides(argv: Sequence[str],
                        base: Optional[InputParam] = None) -> InputParam:
    """Apply ``-ini file`` plus reference CLI flags (AuxParam.c:41)."""
    args = list(argv)
    param = dataclasses.replace(base) if base is not None else InputParam()
    i = 0
    while i < len(args):
        flag = args[i]
        if flag == "-ini":
            param = parse_ini(args[i + 1], base=param)
            i += 2
        elif flag in _CLI_FLAGS:
            name, conv = _CLI_FLAGS[flag]
            setattr(param, name, conv(args[i + 1]))
            i += 2
        else:
            raise FaspError(ERROR_INPUT_PAR, f"unknown CLI flag {flag!r}")
    check_param(param)
    return param


# ---------------------------------------------------------------------------
# Fan-out to subsystem params (reference: AuxParam.c:306 fasp_param_init)
# ---------------------------------------------------------------------------

def param_init(inp: Optional[InputParam] = None
               ) -> Tuple[ITSParam, AMGParam, ILUParam, SWZParam]:
    inp = inp if inp is not None else InputParam()
    its = ITSParam(
        itsolver_type=inp.solver_type, precond_type=inp.precond_type,
        stop_type=inp.stop_type, maxit=inp.itsolver_maxit,
        tol=inp.itsolver_tol, abstol=inp.itsolver_abstol,
        restart=inp.itsolver_restart, print_level=inp.print_level)
    amg = AMGParam(
        AMG_type=inp.AMG_type, print_level=inp.print_level,
        maxit=inp.AMG_maxit, tol=inp.AMG_tol, max_levels=inp.AMG_levels,
        coarse_dof=inp.AMG_coarse_dof, cycle_type=inp.AMG_cycle_type,
        smoother=inp.AMG_smoother, smooth_order=inp.AMG_smooth_order,
        presmooth_iter=inp.AMG_presmooth_iter,
        postsmooth_iter=inp.AMG_postsmooth_iter,
        coarse_solver=inp.AMG_coarse_solver, relaxation=inp.AMG_relaxation,
        polynomial_degree=inp.AMG_polynomial_degree,
        coarse_scaling=inp.AMG_coarse_scaling,
        amli_degree=inp.AMG_amli_degree,
        nl_amli_krylov_type=inp.AMG_nl_amli_krylov_type,
        coarsening_type=inp.AMG_coarsening_type,
        interpolation_type=inp.AMG_interpolation_type,
        max_row_sum=inp.AMG_max_row_sum,
        strong_threshold=inp.AMG_strong_threshold,
        truncation_threshold=inp.AMG_truncation_threshold,
        aggressive_level=inp.AMG_aggressive_level,
        aggressive_path=inp.AMG_aggressive_path,
        aggregation_type=inp.AMG_aggregation_type,
        quality_bound=inp.AMG_quality_bound, pair_number=inp.AMG_pair_number,
        strong_coupled=inp.AMG_strong_coupled,
        max_aggregation=inp.AMG_max_aggregation,
        tentative_smooth=inp.AMG_tentative_smooth,
        smooth_filter=inp.AMG_smooth_filter,
        smooth_restriction=inp.AMG_smooth_restriction,
        ILU_type=inp.ILU_type, ILU_levels=inp.AMG_ILU_levels,
        ILU_lfil=inp.ILU_lfil, ILU_droptol=inp.ILU_droptol,
        ILU_relax=inp.ILU_relax, ILU_permtol=inp.ILU_permtol,
        SWZ_levels=inp.AMG_SWZ_levels, SWZ_mmsize=inp.SWZ_mmsize,
        SWZ_maxlvl=inp.SWZ_maxlvl, SWZ_type=inp.SWZ_type,
        SWZ_blksolver=inp.SWZ_blksolver)
    ilu = ILUParam(print_level=inp.print_level, ILU_type=inp.ILU_type,
                   ILU_lfil=inp.ILU_lfil, ILU_droptol=inp.ILU_droptol,
                   ILU_relax=inp.ILU_relax, ILU_permtol=inp.ILU_permtol)
    swz = SWZParam(print_level=inp.print_level, SWZ_type=inp.SWZ_type,
                   SWZ_maxlvl=inp.SWZ_maxlvl, SWZ_mmsize=inp.SWZ_mmsize,
                   SWZ_blksolver=inp.SWZ_blksolver)
    return its, amg, ilu, swz
