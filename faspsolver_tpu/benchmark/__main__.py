"""CLI: python -m faspsolver_tpu.benchmark [--data DIR] [--solver amg|ilu|cg]
[--min N] [--max N] [--corpus [--scale N]] [--gen]

Reference: benchmark/run.sh driving benchmark.ex over benchmark/input.dat.
Runs on JAX's default device.  The working precision follows
``jax_enable_x64`` (``JAX_ENABLE_X64=1``: f64 throughout; unset: f32
solves with f64 refinement).
"""
import sys


def main(argv) -> int:
    from .harness import run_benchmark, run_corpus, run_generated

    def opt(flag, default):
        return argv[argv.index(flag) + 1] if flag in argv else default

    solver = opt("--solver", "ilu")
    if "--corpus" in argv:
        results = run_corpus(solver_kind=opt("--solver", "amg"),
                             scale=int(opt("--scale", 255)))
    elif "--gen" in argv:
        results = run_generated(solver_kind=opt("--solver", "amg"))
    else:
        datadir = opt("--data", "/root/reference/data")
        results = run_benchmark(datadir, solver_kind=solver,
                                min_size=int(opt("--min", 0)),
                                max_size=int(opt("--max", 200_000)))
    return 0 if results and all(r.converged for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
