"""Multi-device scaling / parity check for the sharded structured solver.

Runs the same AMG-PCG solve on 1, 2, 4, and 8 devices of a mesh and
asserts identical iteration counts (the correctness contract of the
distribution layer), reporting per-configuration wall times.

It runs on a virtual 8-device CPU mesh, where only parity is meaningful
(timings on the virtual mesh are not device numbers):

    python tools/scaling_check.py [n]

``chip_smoke.py --devices 4`` checks the same parity on four GPUs.
"""
import os
import sys
import time

import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)   # parity needs f64 depth
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from faspsolver_tpu.krylov import pcg
from faspsolver_tpu.parallel import (dist_dia_operator, make_mesh,
                                     shard_hierarchy, shard_vector)
from faspsolver_tpu.precond import AMGPrecond
from faspsolver_tpu.precond.amg import setup_structured
from faspsolver_tpu.testgen import poisson_2d
from faspsolver_tpu.utils.params import AMGParam


def main(n: int = 256) -> int:
    lines = []

    def emit(s):
        print(s)
        lines.append(s)

    A = poisson_2d(n)                       # n^2 dof
    b = A.matvec(np.ones(A.nrow))
    hier = setup_structured(A, AMGParam(coarse_dof=400), smooth_p=True)
    assert hier is not None

    ndev = len(jax.devices())
    results = {}
    emit(f"# scaling_check n={n} ({A.nrow} dof), platform="
         f"{jax.devices()[0].platform}, {ndev} devices")
    emit("## GSPMD path (dist_dia_operator + sharded hierarchy)")
    for k in (1, 2, 4, 8):
        if k > ndev or A.nrow % k:
            continue
        mesh = make_mesh(k)
        op = dist_dia_operator(A, mesh)
        hs = shard_hierarchy(hier, mesh, min_size=n)
        bd = shard_vector(jnp.asarray(b, dtype=op.dtype), mesh)
        r = pcg(op, bd, M=AMGPrecond(hs), tol=1e-10, maxit=200)
        float(jnp.sum(r.x))                 # sync
        t0 = time.perf_counter()
        r = pcg(op, bd, M=AMGPrecond(hs), tol=1e-10, maxit=200)
        float(jnp.sum(r.x))
        dt = time.perf_counter() - t0
        results[k] = (int(r.iters), dt, bool(r.converged))
        emit(f"{k} device(s): iters={int(r.iters):3d} "
             f"t={dt*1e3:8.1f} ms converged={bool(r.converged)}")

    iters = {v[0] for v in results.values()}
    ok = len(iters) == 1 and all(v[2] for v in results.values())
    emit(f"PARITY {'OK' if ok else 'FAILED'} - iteration counts: {iters}")

    # PRODUCTION distributed path: explicit halo-exchange AMG
    # (halo_shard_hierarchy: per-level HaloDiaOperators + CommMaps),
    # AMG-PCG through it, whole-cycle HLO comm assertion — the
    # combination the solver actually ships with (SURVEY §7 step 11).
    from faspsolver_tpu.parallel import (assert_neighbor_comm_only,
                                         cycle_comm_pattern,
                                         halo_shard_hierarchy)
    emit("## halo-AMG production path (shard_map + ppermute, "
         "AMG-preconditioned PCG)")
    halo_iters = {}
    itemsize = np.dtype(hier.levels[0].A.dtype).itemsize
    for k in (1, 2, 4, 8):
        if k > ndev or A.nrow % k:
            continue
        mesh = make_mesh(k)
        hh, cmaps = halo_shard_hierarchy(hier, mesh, min_size=n)
        bd = shard_vector(jnp.asarray(b, dtype=hh.levels[0].A.dtype), mesh)
        r = pcg(hh.levels[0].A, bd, M=AMGPrecond(hh), tol=1e-10, maxit=200)
        float(jnp.sum(r.x))
        t0 = time.perf_counter()
        r = pcg(hh.levels[0].A, bd, M=AMGPrecond(hh), tol=1e-10, maxit=200)
        float(jnp.sum(r.x))
        dt = time.perf_counter() - t0
        halo_iters[k] = int(r.iters)
        hlo = cycle_comm_pattern(hh, mesh)
        try:
            assert_neighbor_comm_only(hlo, A.nrow)
            pat = "neighbor-permute-only"
        except AssertionError as e:
            pat = f"VIOLATION({e})"
        plans = "; ".join(
            ("replicated" if c.replicated else
             f"halo={c.halo} ({c.bytes_per_exchange * itemsize}B/edge)")
            for c in cmaps)
        emit(f"{k} device(s): iters={int(r.iters):4d} t={dt*1e3:8.1f} ms "
             f"converged={bool(r.converged)} cycle-comm={pat}")
        emit(f"    per-level comm plans: {plans}")
    ok_h = (len(set(halo_iters.values())) == 1
            and set(halo_iters.values()) == iters)
    emit(f"HALO-AMG PARITY {'OK' if ok_h else 'FAILED'} - iteration "
         f"counts: {set(halo_iters.values())} (GSPMD path: {iters})")

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "scaling_check.out")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"(recorded to {out})")
    return 0 if (ok and ok_h) else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 256))
