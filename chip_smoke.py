"""Smoke test of the AMG-Krylov main path on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --devices 4   # halo-sharded AMG-PCG on four cards
                                       # against the same solve on one

The script stops with a non-zero exit code before any phase when JAX's
default backend is not a GPU, and when any phase fails.  Each phase drives
the library through the entry points a user calls and checks its result
against a plain reference on the host; the last line of standard output is
one JSON object naming the device.

Phases (one card):
  1. structured SA-AMG + packed resident f32/f64 refinement on the 2-D FD
     Poisson at 1023^2 and 4095^2, relres verified in f64 on the host;
  2. classical RS-AMG + the same refiner on the 1M-dof P1-FE Poisson;
  3. the ini/CLI driver in f64 (``python -m faspsolver_tpu``), in process;
  4. stencil probe: XLA's fused 5-point apply against a 1-band copy at
     8191^2 f32 (marginal time per apply, bench.py's method);
  5. precision: the exact band factorization, the 5-point apply in f64 and
     f32 against scipy, and phases 1-2's iteration counts against the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import time

import numpy as np

TOL = 1e-6           # refined solves (phases 1-2), relative residual in f64
CLI_TOL = 1e-8       # the CLI's own tolerance (phase 3)

# Inner PCG iterations of phases 1-2 on the CPU backend (XLA CPU, f32
# inner solves, same code and parameters).  On the card sums run in
# another order, which can move a refinement round's stopping point by an
# iteration or two; a product rounded to TF32 would cost far more.
CPU_INNER_ITERS = {"structured-1023": 19, "rs-fe-1024": 19}
ITER_SLACK = 1.25

# f64: each output is a sum of five terms of size ~|4 h^-2 x|; summed in
# any order the rounding error stays within a few ulp (2.2e-16) of the
# largest term, far below 1e-13 of max|y|.
F64_APPLY_TOL = 1e-13
# f32: one ulp is ~1.2e-7 relative and there are five terms; 2e-6 of
# max|y| leaves room for cancellation against the largest term.
F32_APPLY_TOL = 2e-6


def check_device(count: int = 1):
    """Print the device and every card's name and power limit; raise
    unless JAX runs on at least ``count`` GPUs."""
    from faspsolver_tpu.utils.runtime import card_info, require_gpu
    devs = require_gpu(count)
    print(f"nvidia-smi: {card_info()}", flush=True)
    return devs


def _report(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _relres(A, x, b) -> float:
    return float(np.linalg.norm(b - A.matvec(np.asarray(x, np.float64)))
                 / np.linalg.norm(b))


def _solve_refined(name: str, A, b, runner, setup_s: float) -> int:
    """Compile the packed refiner, solve twice, verify in f64 on the host.
    Returns the inner iteration count."""
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    compiled = runner.compile(jax.ShapeDtypeStruct((A.nrow,), jnp.float32))
    compile_s = time.perf_counter() - t0
    solve_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        x, relres_dev, rounds, iters = compiled(jnp.asarray(b, jnp.float32))
        x = np.asarray(x)
        solve_s.append(time.perf_counter() - t0)
    relres = _relres(A, x, b)
    _report(name, n=A.nrow, nnz=A.nnz, setup_s=f"{setup_s:.4f}",
            compile_s=f"{compile_s:.2f}", solve_first_s=f"{solve_s[0]:.4f}",
            solve_s=f"{solve_s[1]:.4f}", rounds=int(rounds),
            inner_iters=int(iters), relres_device=f"{float(relres_dev):.3e}",
            relres_f64_host=f"{relres:.3e}")
    if not relres < TOL:
        raise RuntimeError(f"{name}: relres {relres:.3e} >= {TOL}")
    return int(iters)


def structured_phase(A, name: str) -> int:
    """Phase 1: the bench's structured headline configuration."""
    import jax
    import jax.numpy as jnp

    from faspsolver_tpu.constants import SmootherType
    from faspsolver_tpu.precond.amg import setup_structured
    from faspsolver_tpu.solvers.refine import make_resident_refiner_packed
    from faspsolver_tpu.utils.params import AMGParam

    b = A.matvec(np.ones(A.nrow))
    param = AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                     polynomial_degree=2, coarse_dof=800,
                     tentative_smooth=0.67)
    t0 = time.perf_counter()
    hier = setup_structured(A, param, dtype=jnp.float32, smooth_p=True,
                            keep_f64_fine=True, pack=True)
    if hier is None or hier.p64 is None:
        raise RuntimeError(f"{name}: did not take the packed structured path")
    jax.block_until_ready(hier.p32.bufs + hier.p64.bufs)
    setup_s = time.perf_counter() - t0
    runner = make_resident_refiner_packed(hier, tol=TOL, max_rounds=4,
                                          maxit_inner=40, cast_b=True)
    return _solve_refined(name, A, b, runner, setup_s)


def rs_phase(m: int, name: str) -> int:
    """Phase 2: the bench's general RS-AMG configuration on the P1-FE
    Poisson over an m x m mesh."""
    import jax
    import jax.numpy as jnp

    from faspsolver_tpu.constants import SmootherType
    from faspsolver_tpu.precond.amg.setup_rs import setup_rs
    from faspsolver_tpu.solvers.refine import make_resident_refiner_packed
    from faspsolver_tpu.testgen import assemble_poisson, unit_square_mesh
    from faspsolver_tpu.utils.params import AMGParam

    A, b, _ = assemble_poisson(unit_square_mesh(m),
                               lambda p: np.ones(len(p)))
    param = AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                     polynomial_degree=3, presmooth_iter=2,
                     postsmooth_iter=2, coarse_dof=800, aggressive_level=1)
    timings = {}
    t0 = time.perf_counter()
    hier = setup_rs(A, param, dtype=jnp.float32, keep_f64_fine=True,
                    pack=True, timings=timings, filter_smoother=True)
    jax.block_until_ready(hier.p32.bufs + hier.p64.bufs)
    setup_s = time.perf_counter() - t0
    _report(name + " setup",
            **{k: (f"{v:.4f}" if isinstance(v, float) else v)
               for k, v in timings.items()})
    runner = make_resident_refiner_packed(
        hier, tol=TOL, inner_tol=1e-4, inner_floor=1e-4, max_rounds=6,
        maxit_inner=40, cast_b=True)
    return _solve_refined(name, A, b, runner, setup_s)


def cli_phase(size: int) -> None:
    """Phase 3: the CLI in process (one JAX process on the card)."""
    from faspsolver_tpu.__main__ import main as cli

    argv = ["-problem", "poisson2d", "-size", str(size), "-precond", "2",
            "-tol", str(CLI_TOL)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="")
    m = re.search(r"relative residual ([-+.0-9eE]+)", out)
    relres = float(m.group(1).rstrip(".")) if m else float("nan")
    _report("cli", argv=" ".join(argv), rc=rc, wall_s=f"{wall:.2f}",
            relres_f64_host=f"{relres:.3e}")
    if rc != 0 or not relres < CLI_TOL:
        raise RuntimeError(f"cli: rc={rc}, relres={relres:.3e}")


def five_point(nx: int, dtype):
    """Constant 5-point StencilNdOperator on an nx x nx grid."""
    import jax.numpy as jnp

    from faspsolver_tpu.ops.operators import StencilNdOperator
    coefs = (-0.2499, -0.2499, 0.99999, -0.2499, -0.2499)
    coords = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    return StencilNdOperator(tuple(jnp.full((1, 1), c, dtype)
                                   for c in coefs), coords, (nx, nx))


def stencil_probe(nx: int, reps: int = 50) -> None:
    """Phase 4: marginal time of the fused 5-point apply and of a copy
    (1-band shifted scale) through the same chain; both counted as one
    read and one write of an f32 vector."""
    import jax
    import jax.numpy as jnp

    from bench import chain_timer, marginal_us
    from faspsolver_tpu.ops.operators import StencilNdOperator

    n = nx * nx
    v = jnp.ones(n, jnp.float32)
    copy = StencilNdOperator((jnp.full((1, 1), 0.9995, jnp.float32),),
                             ((0, 1),), (nx, nx))
    copy_us, _ = marginal_us(chain_timer(copy, v), reps=reps)
    five_us, fixed_us = marginal_us(chain_timer(five_point(nx, jnp.float32),
                                                v), reps=reps)
    gbs = lambda us: 2 * n * 4 / (us * 1e-6) / 1e9  # noqa: E731
    _report("stencil-probe", grid=f"{nx}^2", dtype="float32",
            card=jax.devices()[0].device_kind,
            copy_us=f"{copy_us:.2f}", copy_gbs=f"{gbs(copy_us):.1f}",
            five_point_us=f"{five_us:.2f}",
            five_point_gbs=f"{gbs(five_us):.1f}",
            five_over_copy=f"{copy_us / five_us:.3f}",
            chain_fixed_us=f"{fixed_us:.1f}")


def precision_phase(A, iters: dict) -> None:
    """Phase 5: exactness and tolerances of the f32/f64 products."""
    import jax
    import jax.numpy as jnp

    from faspsolver_tpu.ops.operators import FactoredBand, factor_band_2d
    from faspsolver_tpu.precond.amg.band_algebra import BandMatrix

    nx = int(round(np.sqrt(A.nrow)))
    rng = np.random.default_rng(0)
    # a band with 3 distinct rows and 3 distinct columns (boundary rows
    # and columns differ from the interior), entries with full mantissas
    core = rng.standard_normal((3, 3)).astype(np.float32)
    groups = np.ones(nx, np.int64)
    groups[0], groups[-1] = 0, 2
    band = core[groups][:, groups]
    fac = factor_band_2d(band)
    if fac is None or fac[0].shape[1] != 3:
        raise RuntimeError("test band did not factor as 3 x 3")
    got = np.asarray(FactoredBand(*(jnp.asarray(a) for a in fac))
                     .materialize())
    exact = bool(np.array_equal(got, band))
    _report("precision factored-band", shape=band.shape,
            bit_exact=exact, max_abs_diff=float(np.abs(got - band).max()))
    if not exact:
        raise RuntimeError("FactoredBand.materialize is not exact in f32")

    As = A.to_scipy()
    x = rng.standard_normal(A.nrow)
    for dtype, tol in ((np.float64, F64_APPLY_TOL),
                       (np.float32, F32_APPLY_TOL)):
        op = jax.device_put(BandMatrix.from_csr(A, (nx, nx))
                            .to_stencil_operator(dtype))
        xd = x.astype(dtype)
        y = np.asarray(op(jnp.asarray(xd)), np.float64)
        yref = As @ xd.astype(np.float64)
        err = float(np.abs(y - yref).max() / np.abs(yref).max())
        _report("precision stencil-apply", grid=f"{nx}^2",
                dtype=np.dtype(dtype).name, max_rel_err=f"{err:.3e}",
                tol=tol)
        if not err <= tol:
            raise RuntimeError(f"{np.dtype(dtype).name} 5-point apply: "
                               f"{err:.3e} > {tol}")

    for key, got_iters in iters.items():
        ref = CPU_INNER_ITERS[key]
        _report("precision iterations", case=key, gpu=got_iters, cpu=ref,
                limit=f"{ITER_SLACK}x")
        if got_iters > ITER_SLACK * ref:
            raise RuntimeError(f"{key}: {got_iters} inner iterations on "
                               f"the GPU vs {ref} on the CPU")


def sharded_phase(nx: int, ndev: int) -> None:
    """--devices N: halo-sharded structured AMG-PCG on N cards against the
    same solve on device 0 alone."""
    import jax
    import jax.numpy as jnp

    from faspsolver_tpu.krylov import pcg
    from faspsolver_tpu.parallel import (assert_neighbor_comm_only,
                                         cycle_comm_pattern,
                                         halo_shard_hierarchy, make_mesh,
                                         shard_vector)
    from faspsolver_tpu.precond import AMGPrecond
    from faspsolver_tpu.precond.amg import setup_structured
    from faspsolver_tpu.testgen import poisson_2d
    from faspsolver_tpu.utils.params import AMGParam

    mesh = make_mesh(ndev)
    A = poisson_2d(nx)
    if A.nrow % ndev:
        raise ValueError(f"{A.nrow} rows do not split over {ndev} devices")
    b = A.matvec(np.ones(A.nrow))
    t0 = time.perf_counter()
    hs = setup_structured(A, AMGParam(coarse_dof=60), dtype=jnp.float32,
                          smooth_p=True)
    hh, cmaps = halo_shard_hierarchy(hs, mesh)
    setup_s = time.perf_counter() - t0
    if cmaps[0].replicated or cmaps[0].halo <= 0:
        raise RuntimeError("fine level did not take the halo operator")
    t0 = time.perf_counter()
    assert_neighbor_comm_only(cycle_comm_pattern(hh, mesh), A.nrow)
    comm_s = time.perf_counter() - t0

    def solve(op, M, rhs):
        res = pcg(op, rhs, M=M, tol=1e-5, maxit=100)
        res.x.block_until_ready()                  # compile + first run
        t0 = time.perf_counter()
        res = pcg(op, rhs, M=M, tol=1e-5, maxit=100)
        res.x.block_until_ready()
        return res, time.perf_counter() - t0

    bd = shard_vector(jnp.asarray(b, jnp.float32), mesh)
    res_n, t_n = solve(hh.levels[0].A, AMGPrecond(hh), bd)
    res_1, t_1 = solve(hs.levels[0].A, AMGPrecond(hs),
                       jax.device_put(jnp.asarray(b, jnp.float32),
                                      jax.devices()[0]))
    x_n = np.asarray(res_n.x, np.float64)
    x_1 = np.asarray(res_1.x, np.float64)
    xdiff = float(np.linalg.norm(x_n - x_1) / np.linalg.norm(x_1))
    # b = A 1, so the exact solution is all ones
    err_1 = float(np.linalg.norm(x_1 - 1.0) / np.sqrt(A.nrow))
    _report("sharded", devices=ndev, n=A.nrow, setup_s=f"{setup_s:.3f}",
            comm_check_s=f"{comm_s:.2f}", levels=len(cmaps),
            halo_levels=sum(not c.replicated for c in cmaps),
            iters_sharded=int(res_n.iters), iters_one=int(res_1.iters),
            solve_sharded_s=f"{t_n:.4f}", solve_one_s=f"{t_1:.4f}",
            relres_sharded=f"{_relres(A, x_n, b):.3e}",
            relres_one=f"{_relres(A, x_1, b):.3e}", x_rel_diff=f"{xdiff:.3e}",
            x_rel_err_one=f"{err_1:.3e}")
    if not (bool(res_n.converged) and bool(res_1.converged)):
        raise RuntimeError("sharded phase: a solve did not converge")
    if int(res_n.iters) != int(res_1.iters):
        raise RuntimeError("sharded phase: iteration counts differ")
    # Both runs are f32 PCG to relres 1e-5 and differ only in the order of
    # the sums across shards.  At this size f32 PCG stalls near relres
    # 1e-6, so two such solutions can only be asked to agree to within
    # their own distance from the exact solution.
    if not xdiff <= err_1:
        raise RuntimeError(f"sharded phase: solutions differ by {xdiff:.3e}, "
                           f"more than the one-card error {err_1:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the halo-sharded phase on 4 cards")
    args = ap.parse_args(argv)

    import jax
    devs = check_device(args.devices)
    from faspsolver_tpu import native
    from faspsolver_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    try:
        native.build()
    except subprocess.CalledProcessError as e:
        print(e.stderr, file=sys.stderr)
        raise
    if not native.available():
        raise RuntimeError("native setup library failed to load")

    if args.devices > 1:
        sharded_phase(4096, args.devices)
    else:
        from faspsolver_tpu.testgen import poisson_2d
        iters = {"structured-1023": structured_phase(poisson_2d(1023),
                                                     "structured-1023")}
        A4095 = poisson_2d(4095)
        structured_phase(A4095, "structured-4095")
        iters["rs-fe-1024"] = rs_phase(1024, "rs-fe-1024")
        cli_phase(1023)
        stencil_probe(8191)
        precision_phase(A4095, iters)

    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
