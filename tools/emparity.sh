#!/bin/bash
# Reproduce docs/ENERGYMIN_PARITY.md: reference vs framework iteration
# counts for DIR/STD/energy-min interpolation on the FE-3969 corpus.
set -e
REF=${REF:-/root/reference}
BUILD=/tmp/faspbuild
[ -x $BUILD/test/test.ex ] || {
  cmake -S $REF -B $BUILD -DCMAKE_BUILD_TYPE=Release >/dev/null
  cmake --build $BUILD -j8 >/dev/null
}
INI=$(mktemp)
sed -e 's|^workdir.*|workdir = '"$REF"'/data/|' \
    -e 's/^problem_num.*/problem_num = 10/' \
    -e 's/^solver_type.*= 6.*/solver_type = 1/' \
    -e 's/^AMG_type.*= UA.*/AMG_type = C/' \
    -e 's/^print_level.*/print_level = 1/' $REF/test/ini/bsr.dat > $INI
for it in 1 2 3; do
  sed -i "s/^AMG_interpolation_type.*/AMG_interpolation_type = $it/" $INI
  echo "reference interp=$it: $(cd /tmp && $BUILD/test/test.ex -ini $INI 2>/dev/null | grep 'Number of iterations')"
done
PYTHONPATH="$(cd "$(dirname "$0")/.." && pwd)" JAX_PLATFORMS=cpu python - << 'PYEOF'
import jax; jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from faspsolver_tpu.io import read_csrvec
from faspsolver_tpu.precond.amg.setup_rs import setup_rs
from faspsolver_tpu.precond import AMGPrecond
from faspsolver_tpu.krylov import pcg
from faspsolver_tpu.utils.params import AMGParam
from faspsolver_tpu.constants import SmootherType
A, b = read_csrvec("/root/reference/data/csrmat_FE.dat", "/root/reference/data/rhs_FE.dat")
for it, name in [(1,"DIR"), (2,"STD"), (3,"ENERGYMIN")]:
    h = setup_rs(A, AMGParam(interpolation_type=it, smoother=int(SmootherType.GS)), dtype=jnp.float64)
    res = pcg(h.levels[0].A, jnp.asarray(b), M=AMGPrecond(h), tol=1e-14, maxit=200)
    print(f"framework {name}: iters {int(res.iters)} relres {float(res.relres):.2e}")
PYEOF
