"""Headline benchmark: AMG-PCG time-to-1e-6 on the 1,046,529-dof 2D Poisson.

Reference baseline (BASELINE.md): CG + classical RS-AMG V-cycle on the same
size problem, gcc -O2, 4 OpenMP threads: setup 1.4029 s + solve 1.5566 s =
2.9973 s total (test/out/poisson-O2-th4.out).  vs_baseline here is the
speedup factor: reference_total / ours_total (>1 means faster than the
reference).

Configuration (the framework's structured fast mode):
- structured smoothed-aggregation AMG with EXACT compressed stencil
  operators (StencilNdOperator): constant-coefficient bands collapse to a
  few scalars, so setup ships ~KB to the device instead of ~25 MB and the
  SpMV streams only x and y from device memory (the least traffic any
  matvec can have);
- device-resident mixed-precision refinement (solvers.refine
  make_resident_refiner): ONE jitted program runs every refinement round —
  f64 true residuals on-device against the exact compressed f64 fine
  operator, around an f32 AMG-PCG inner solve.  The solve costs one b
  upload + compute + one x readback; the returned solution is verified in
  f64 on the host (reported, untimed — the reference also checks its
  residual outside the timed region, test/main/test.c:428-430).

Timed regions match the reference's: setup starts from the host CSR matrix
(includes all host->device movement), solve ends with the f64 solution in
host memory.  Compile time is excluded (AOT-compiled before timing; the
reference has no JIT cost), as is backend bring-up (process startup).

SpMV metric methodology: chained K SpMVs per normalization at two K values
— the marginal time (t[K=8]-t[K=1])/7 removes the fixed per-iteration
chain overhead (loop + reduction latency).  The copy probe uses the
IDENTICAL chain shape, so spmv/copy are directly comparable.

Runs on a GPU only (exits non-zero otherwise).  Prints ONE JSON line.
"""
from __future__ import annotations

import json
import time
from functools import partial

import numpy as np


def marginal_us(timed_chain, k_lo: int = 1, k_hi: int = 8,
                reps: int = 100, tries: int = 3) -> tuple:
    """Best-of-N marginal per-op time via two chain lengths (us).
    Returns (marginal_us, fixed_overhead_us)."""
    t_lo = min(timed_chain(k_lo, reps) for _ in range(tries)) / reps
    t_hi = min(timed_chain(k_hi, reps) for _ in range(tries)) / reps
    marg = (t_hi - t_lo) / (k_hi - k_lo)
    fixed = t_lo - marg * k_lo
    return marg * 1e6, max(fixed, 0.0) * 1e6


def chain_timer(fn, v0):
    """``timed(k, reps)``: seconds for ``reps`` rounds of ``k`` chained
    applications of ``fn`` to ``v0``, each round ending in a
    normalization; both chain shapes used by :func:`marginal_us` are
    compiled before the first timing."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("k", "reps"))
    def chain(v, k: int, reps: int):
        def body(_, vv):
            for _ in range(k):
                # the barrier forces each step to materialize: without it
                # XLA fuses/folds chained ops and the "marginal time"
                # measures nothing
                vv = jax.lax.optimization_barrier(fn(vv))
            return vv * jax.lax.rsqrt(jnp.vdot(vv, vv))
        return jax.lax.fori_loop(0, reps, body, v)

    def timed(k, nrep):
        t0 = time.perf_counter()
        chain(v0, k=k, reps=nrep).block_until_ready()
        return time.perf_counter() - t0

    for k in (1, 8):
        chain(v0, k=k, reps=2).block_until_ready()
    return timed


def main() -> None:
    import jax

    from faspsolver_tpu.utils.runtime import enable_compile_cache, \
        require_gpu
    require_gpu()
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)   # resident f64 refinement
    import jax.numpy as jnp
    from faspsolver_tpu import native
    from faspsolver_tpu.precond.amg import setup_structured
    from faspsolver_tpu.solvers.refine import make_resident_refiner_packed
    from faspsolver_tpu.testgen import poisson_2d
    from faspsolver_tpu.utils.params import AMGParam
    from faspsolver_tpu.constants import SmootherType

    NX = 1023                      # 1023^2 = 1,046,529 dof
    REF_TOTAL_S = 2.9973           # reference -O2 4-thread setup+solve
    TOL = 1e-6

    dtype = jnp.float32            # hot-loop precision (performance mode)

    # native kernel library: built once per checkout and host (like the
    # reference's own gcc build, which its timings exclude)
    native.build()

    t0 = time.perf_counter()
    A = poisson_2d(NX)
    gen_s = time.perf_counter() - t0

    # ---- AMG setup (host band algebra -> compressed device freeze) ----
    # The HEADLINE uses the COLD (first) setup run — the reference baseline
    # is a cold setup too (test/out/poisson-O2-th4.out pays no warm cache).
    # A second run is recorded as setup_warm_s so cache effects are visible
    # rather than silently flattering the number.
    param = AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                     polynomial_degree=2, coarse_dof=800,
                     tentative_smooth=0.67)

    setup_runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        hier = setup_structured(A, param, dtype=dtype, smooth_p=True,
                                keep_f64_fine=True, pack=True)
        assert hier is not None and hasattr(hier, "p32"), \
            "bench problem must take the packed structured path"
        jax.block_until_ready(hier.p32.bufs + hier.p64.bufs)
        setup_runs.append(time.perf_counter() - t0)
    setup_s = setup_runs[0]
    assert hier.p64 is not None
    b = A.matvec(np.ones(A.nrow))

    # b ships as f32 (half the h2d bytes); the device promotes to f64 and
    # refines against the f32-rounded b (relative perturbation ~6e-8 <<
    # TOL=1e-6).  Honesty is preserved: the
    # verified residual below is computed on host against the EXACT b.
    runner = make_resident_refiner_packed(hier, tol=TOL, max_rounds=4,
                                          maxit_inner=40, cast_b=True)
    # concrete device hierarchy for the SpMV micro-benchmarks (untimed)
    hier_c = hier.materialize()
    op = hier_c.levels[0].A                     # fine stencil op (f32)

    # ---- AOT compile + executable warmup (excluded: the reference pays
    # no JIT cost; the first execution is warmed on dummy data) ----
    compiled = runner.compile(
        jax.ShapeDtypeStruct((A.nrow,), jnp.float32))
    jax.block_until_ready(compiled(jnp.ones(A.nrow, jnp.float32)))

    # ---- timed solve: b (host f64) -> x (host f64) ----
    t0 = time.perf_counter()
    b_dev = jnp.asarray(b, dtype=jnp.float32)
    x_dev, relres_dev, rounds_dev, iters_dev = compiled(b_dev)
    x = np.asarray(x_dev)
    solve_s = time.perf_counter() - t0
    relres = float(relres_dev)
    rounds = int(rounds_dev)
    inner_iters = int(iters_dev)

    # untimed f64 verification on host (reference checks its residual
    # outside the timed region too)
    r = b - A.matvec(x)
    relres_verified = float(np.linalg.norm(r) / np.linalg.norm(b))

    total_s = setup_s + solve_s

    # ---- SpMV / stream throughput: marginal-time methodology ----
    reps = 100
    bdev32 = jnp.asarray(b, dtype=dtype)

    spmv_us, chain_fixed_us = marginal_us(chain_timer(op, bdev32), reps=reps)
    # copy probe: a 1-point stencil (scaled shift) through the SAME
    # machinery — one read + one write per element, structurally immune to
    # the constant folding that collapses chained affine elementwise ops
    from faspsolver_tpu.ops.operators import StencilNdOperator
    one_band = StencilNdOperator(
        (jnp.asarray(np.full((1, 1), 0.9995, dtype=np.float32)),),
        ((0, 1),), (NX, NX))
    stream_us, _ = marginal_us(chain_timer(one_band, bdev32), reps=reps)

    bytes_per = np.dtype(np.float32).itemsize
    n = A.nrow
    # stencil SpMV true traffic: read x + write y (coefficients are
    # register-resident compressed bands) — identical to the stream probe's
    # read+write, so the ratio is the fraction of achievable bandwidth
    spmv_traffic = 2 * n * bytes_per
    spmv_gbs = spmv_traffic / (spmv_us / 1e6) / 1e9
    stream_gbs = 2 * n * bytes_per / (stream_us / 1e6) / 1e9
    nnz_per_s = A.nnz / (spmv_us / 1e6)

    # ---- device-memory-bound probes: the 1M-dof probes above have 4 MB
    # working sets that sit in the GPU's L2 cache, so stream_gbs is a
    # cache rate.  The same chain methodology at 8192^2 = 67M dof (268 MB
    # per vector, over 5x a 50 MB L2) makes every element round-trip device
    # memory: spmv_vs_hbm_sol is the 5-point apply's fraction of a copy.
    NH = 8192
    nh = NH * NH
    vbig = jnp.ones(nh, dtype=jnp.float32)
    one_hbm = StencilNdOperator(
        (jnp.asarray(np.full((1, 1), 0.9995, dtype=np.float32)),),
        ((0, 1),), (NH, NH))
    coefs5 = (-0.2499, -0.2499, 0.99999, -0.2499, -0.2499)
    coords5 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    five_hbm = StencilNdOperator(
        tuple(jnp.asarray(np.full((1, 1), c, dtype=np.float32))
              for c in coefs5), coords5, (NH, NH))
    stream_hbm_us, _ = marginal_us(chain_timer(one_hbm, vbig),
                                   reps=10, tries=3)
    spmv_hbm_us, _ = marginal_us(chain_timer(five_hbm, vbig),
                                 reps=10, tries=3)
    del vbig
    stream_hbm_gbs = 2 * nh * bytes_per / (stream_hbm_us / 1e6) / 1e9
    spmv_hbm_gbs = 2 * nh * bytes_per / (spmv_hbm_us / 1e6) / 1e9
    hbm = {
        "stream_hbm_gbs": round(stream_hbm_gbs, 2),
        "spmv_hbm_gbs": round(spmv_hbm_gbs, 2),
        "spmv_vs_hbm_sol": round(spmv_hbm_gbs / stream_hbm_gbs, 3),
        "hbm_probe_dof": nh,
    }

    # ---- General path: the reference's ACTUAL stored-baseline problem —
    # 1,046,529-dof P1-FE Poisson (7.3M nnz) through classical RS-AMG
    # (coarsen -> interpolate -> native fused RAP) + CG refinement.
    # This is the same-algorithm comparison: the reference does it in
    # 1.40 s setup + 1.56 s solve (-O2, 4 threads,
    # test/out/poisson-O2-th4.out).  The structured headline above is the
    # framework's fast mode; this measures the general unstructured
    # machinery on the same problem.
    from faspsolver_tpu.testgen import assemble_poisson, unit_square_mesh
    from faspsolver_tpu.precond.amg.setup_rs import setup_rs

    t0 = time.perf_counter()
    mesh = unit_square_mesh(NX + 1)
    Afe, bfe, _ = assemble_poisson(mesh, lambda p: np.ones(len(p)))
    fe_gen_s = time.perf_counter() - t0

    # aggressive (path-2) first-level coarsening + standard interp:
    # removes the factor-2 523k level (half the host setup work) at
    # ~2x the inner iterations; the classical default stays available
    # via aggressive_level=0
    rs_param = AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                        polynomial_degree=3, presmooth_iter=2,
                        postsmooth_iter=2, coarse_dof=800,
                        aggressive_level=1)
    g_tim = {}             # per-phase setup attribution
    t0 = time.perf_counter()
    hfe = setup_rs(Afe, rs_param, dtype=dtype, keep_f64_fine=True,
                   pack=True, timings=g_tim, filter_smoother=True)
    t_up = time.perf_counter()
    jax.block_until_ready(hfe.p32.bufs
                          + (hfe.p64.bufs if hfe.p64 else ()))
    g_tim["upload_s"] = time.perf_counter() - t_up
    g_setup_s = time.perf_counter() - t0

    g_runner = make_resident_refiner_packed(
        hfe, tol=TOL, inner_tol=1e-4, inner_floor=1e-4,
        max_rounds=6, maxit_inner=40, cast_b=True)
    g_compiled = g_runner.compile(
        jax.ShapeDtypeStruct((Afe.nrow,), jnp.float32))
    jax.block_until_ready(g_compiled(jnp.ones(Afe.nrow, jnp.float32)))

    t0 = time.perf_counter()
    gb = jnp.asarray(bfe, dtype=jnp.float32)
    gx, g_rr, g_rnd, g_it = g_compiled(gb)
    gxh = np.asarray(gx)
    g_solve_s = time.perf_counter() - t0
    g_verified = float(np.linalg.norm(bfe - Afe.matvec(gxh))
                       / np.linalg.norm(bfe))
    general = {
        "general_setup_s": round(g_setup_s, 4),
        "general_solve_s": round(g_solve_s, 4),
        "general_total_s": round(g_setup_s + g_solve_s, 4),
        "general_vs_baseline": round(
            REF_TOTAL_S / (g_setup_s + g_solve_s), 3),
        "general_rounds": int(g_rnd),
        "general_inner_iters": int(g_it),
        "general_relres_verified": g_verified,
        "general_converged": bool(g_verified < TOL),
        "general_nnz": Afe.nnz,
        "general_packed_mb": round(
            (hfe.p32.nbytes
             + (hfe.p64.nbytes if hfe.p64 else 0)) / 1e6, 1),
        "general_gen_s": round(fe_gen_s, 2),
        # per-phase setup attribution (host graph algorithms vs the
        # device freeze)
        **{f"general_{k}": (round(v, 3) if isinstance(v, float)
                            else v) for k, v in g_tim.items()},
    }

    # ---- Apples-to-apples headline: the reference's OWN 1M P1-FE
    # matrix through AUTOMATIC dispatch.  The FE matrix is
    # grid-detectable (7 bands), so the structured fast path engages
    # exactly as it would for any user calling the driver — this is
    # the same problem as test/out/poisson-O2-th4.out, not the
    # generated FD stand-in.  Cold setup + solve, headline protocol.
    t0 = time.perf_counter()
    hauto = setup_structured(Afe, param, dtype=dtype, smooth_p=True,
                             keep_f64_fine=True, pack=True)
    assert hauto is not None and hauto.p64 is not None, \
        "P1-FE matrix must take the automatic structured path"
    jax.block_until_ready(hauto.p32.bufs + hauto.p64.bufs)
    a_setup_s = time.perf_counter() - t0
    a_runner = make_resident_refiner_packed(hauto, tol=TOL,
                                            max_rounds=4,
                                            maxit_inner=40,
                                            cast_b=True)
    a_compiled = a_runner.compile(
        jax.ShapeDtypeStruct((Afe.nrow,), jnp.float32))
    jax.block_until_ready(a_compiled(jnp.ones(Afe.nrow, jnp.float32)))
    t0 = time.perf_counter()
    ab = jnp.asarray(bfe, dtype=jnp.float32)
    ax, a_rr, a_rnd, a_it = a_compiled(ab)
    axh = np.asarray(ax)
    a_solve_s = time.perf_counter() - t0
    a_verified = float(np.linalg.norm(bfe - Afe.matvec(axh))
                       / np.linalg.norm(bfe))
    fe_auto_vs = round(REF_TOTAL_S / (a_setup_s + a_solve_s), 3)
    general.update({
        "fe_auto_setup_s": round(a_setup_s, 4),
        "fe_auto_solve_s": round(a_solve_s, 4),
        "fe_auto_total_s": round(a_setup_s + a_solve_s, 4),
        "fe_auto_vs_baseline": fe_auto_vs,
        "fe_auto_inner_iters": int(a_it),
        "fe_auto_relres_verified": a_verified,
        "fe_auto_converged": bool(a_verified < TOL),
    })

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "amg_pcg_total_time_1M_poisson",
        "value": round(total_s, 4),
        "unit": "s",
        "vs_baseline": round(REF_TOTAL_S / total_s, 3),
        "detail": {
            "setup_s": round(setup_s, 4),
            "setup_warm_s": round(setup_runs[1], 4),
            "solve_s": round(solve_s, 4),
            "refine_rounds": rounds,
            "inner_iters": inner_iters,
            "relres": relres,
            "relres_verified_f64": relres_verified,
            "converged": bool(relres_verified < TOL),
            "spmv_us": round(spmv_us, 1),
            "stream_us": round(stream_us, 1),
            "chain_fixed_overhead_us": round(chain_fixed_us, 1),
            "spmv_gbs": round(spmv_gbs, 2),
            # 1M-dof probes: 4 MB working set = an L2-cache rate; the
            # device-memory rate is stream_hbm_gbs below
            "stream_onchip_gbs": round(stream_gbs, 2),
            "spmv_vs_stream": round(stream_us / spmv_us, 3)
            if spmv_us > 0 else None,
            **hbm,
            "spmv_nnz_per_s": round(nnz_per_s / 1e9, 3),
            "n": A.nrow, "nnz": A.nnz,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "dtype": "float32",
            "gen_s": round(gen_s, 3),
            **general,
        },
    }))


if __name__ == "__main__":
    main()
