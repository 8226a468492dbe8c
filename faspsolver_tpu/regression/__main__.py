"""CLI entry: python -m faspsolver_tpu.regression [--mm] [--matfree] [--fast]

Reproduces the reference regression drivers (regression.c /
regression_mm.c / regression_mf.c) and prints the PASS/ATTENTION tally.
Exit code 0 iff everything passed.
"""
import sys

import jax

# conformance tool: always the CPU in double precision, the reference's
# arithmetic, whatever accelerator the machine has (config updates win over
# the JAX_PLATFORMS environment variable)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from .runner import (bsr_configs, bsr_problems, core_configs,
                     matfree_configs, mm_configs, mm_problems,
                     print_tally, run_matrix, _problems)


def main(argv):
    mm = "--mm" in argv
    matfree = "--matfree" in argv
    bsr = "--bsr" in argv
    fast = "--fast" in argv
    if mm:
        results = run_matrix(mm_configs(), mm_problems())
    elif matfree:
        results = run_matrix(matfree_configs(), _problems())
    elif bsr:
        results = run_matrix(bsr_configs(), bsr_problems())
    else:
        cfgs = core_configs()
        probs = _problems()
        if fast:
            cfgs = cfgs[:12]
            probs = probs[:1]
        results = run_matrix(cfgs, probs)
    _, nwarn = print_tally(results)
    return 1 if nwarn else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
