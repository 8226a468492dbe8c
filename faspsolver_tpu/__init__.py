"""faspsolver_tpu: an accelerator-native sparse iterative solver framework.

A from-scratch JAX/XLA re-design with the capabilities of the
reference FASP library (Fast Auxiliary Space Preconditioning): Krylov
subspace methods, algebraic multigrid (classical RS / smoothed aggregation /
unsmoothed aggregation), geometric multigrid, incomplete factorizations, and
Schwarz methods — built for accelerators: static-shape jitted solve loops,
ELL/block-ELL operators, color-batched smoothers, and shard_map row-block
distribution over device meshes.
"""

from . import constants
from .constants import (AMGType, AggregationType, CoarseningType, CycleType,
                        ILUType, InterpType, PrecondType, PrintLevel,
                        SchwarzType, SmootherType, SolverType, StopType)
from .formats import BLCMatrix, BSRMatrix, CSRMatrix, STRMatrix
from .ops import (BsrEllOperator, CooOperator, DenseOperator, EllOperator,
                  MatFreeOperator, default_dtype, device_operator)
from .utils import (AMGParam, FaspError, ILUParam, ITSParam, InputParam,
                    SWZParam, apply_cli_overrides, param_init, parse_ini)

__version__ = "0.1.0"
