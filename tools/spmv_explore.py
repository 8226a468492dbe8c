"""SpMV variant exploration on the device (one-off tool).

Measures time-per-SpMV for layout/fusion variants of the 5-point DIA
operator at 1023^2 (the bench problem).  Needs a GPU.  Run from the
repository root: ``PYTHONPATH=. python tools/spmv_explore.py``.

Variants:
  A  current bench chain: y = A v; v' = y * rsqrt(<y,y>)   (flat 1-D)
  B  scale-folded chain: y = A (s*v) fused, s' = rsqrt(<y,y>)
  C  2-D layout (ny, nx): per-axis shifts, same normalize as A
  D  2-D layout, padded nx 1023->1024 (lane-aligned rows)
  E  bf16 bands, f32 accumulate (halved band traffic), chain as B
"""
from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

NX = 1023
REPS = 300
N = NX * NX


def time_chain(fn, *args):
    out = fn(*args)
    _sync(out)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        runs.append(time.perf_counter() - t0)
    return min(runs) / REPS


def _sync(out):
    jax.block_until_ready(out)


def main():
    from faspsolver_tpu.ops import DiaOperator
    from faspsolver_tpu.utils.runtime import enable_compile_cache, \
        require_gpu
    require_gpu()
    enable_compile_cache()
    from faspsolver_tpu.testgen import poisson_2d

    A = poisson_2d(NX)
    op = DiaOperator.from_csr(A, dtype=jnp.float32)
    x0 = jnp.asarray(np.random.default_rng(0).standard_normal(N),
                     dtype=jnp.float32)
    float(jnp.sum(x0))            # bring-up

    results = {}
    nbytes = op.bands.size * 4 + 3 * N * 4     # bench metric convention

    # ---- A: current chain --------------------------------------------
    @jax.jit
    def chain_a(o, v):
        def body(_, vv):
            y = o(vv)
            return y * jax.lax.rsqrt(jnp.vdot(y, y))
        return jax.lax.fori_loop(0, REPS, body, v)

    t = time_chain(chain_a, op, x0)
    results["A_flat_norm"] = dict(us=t * 1e6, gbs=nbytes / t / 1e9)

    # ---- B: scale-folded ---------------------------------------------
    @jax.jit
    def chain_b(o, v):
        def body(_, carry):
            vv, s = carry
            y = o.scaled_apply(vv, s) if hasattr(o, "scaled_apply") else (
                o(vv * s))
            return y, jax.lax.rsqrt(jnp.vdot(y, y))
        y, s = jax.lax.fori_loop(0, REPS, body,
                                 (v, jnp.float32(1.0)))
        return y * s

    t = time_chain(chain_b, op, x0)
    results["B_scale_fold"] = dict(us=t * 1e6, gbs=nbytes / t / 1e9)

    # ---- C: 2-D layout, unpadded -------------------------------------
    offs, bands = op.offsets, op.bands
    coords = {-NX: (-1, 0), -1: (0, -1), 0: (0, 0), 1: (0, 1), NX: (1, 0)}
    b2d = bands.reshape(len(offs), NX, NX)

    def spmv2d(bb, v2, nx):
        y = jnp.zeros_like(v2)
        vp = jnp.pad(v2, ((1, 1), (1, 1)))
        for k, off in enumerate(offs):
            dy, dx = coords[int(off)]
            y = y + bb[k] * jax.lax.slice(
                vp, (1 + dy, 1 + dx), (1 + dy + NX, 1 + dx + nx))
        return y

    @jax.jit
    def chain_c(bb, v):
        v2 = v.reshape(NX, NX)
        def body(_, vv):
            y = spmv2d(bb, vv, NX)
            return y * jax.lax.rsqrt(jnp.vdot(y, y))
        return jax.lax.fori_loop(0, REPS, body, v2)

    t = time_chain(chain_c, b2d, x0)
    results["C_2d"] = dict(us=t * 1e6, gbs=nbytes / t / 1e9)

    # ---- D: 2-D padded to 1024 columns -------------------------------
    NXP = 1024
    b2p = jnp.pad(b2d, ((0, 0), (0, 0), (0, 1)))
    x2p = jnp.pad(x0.reshape(NX, NX), ((0, 0), (0, 1)))

    def spmv2dp(bb, v2):
        vp = jnp.pad(v2, ((1, 1), (0, 0)))
        y = jnp.zeros_like(v2)
        for k, off in enumerate(offs):
            dy, dx = coords[int(off)]
            if dx == 0:
                sl = jax.lax.slice(vp, (1 + dy, 0), (1 + dy + NX, NXP))
            else:
                vpp = jnp.pad(v2, ((1, 1), (1, 1)))
                sl = jax.lax.slice(vpp, (1 + dy, 1 + dx),
                                   (1 + dy + NX, 1 + dx + NXP))
            y = y + bb[k] * sl
        return y

    @jax.jit
    def chain_d(bb, v2):
        def body(_, vv):
            y = spmv2dp(bb, vv)
            return y * jax.lax.rsqrt(jnp.vdot(y, y))
        return jax.lax.fori_loop(0, REPS, body, v2)

    t = time_chain(chain_d, b2p, x2p)
    results["D_2d_pad"] = dict(us=t * 1e6, gbs=nbytes / t / 1e9)

    # ---- E: bf16 bands, f32 accumulate, scale-folded ------------------
    opbf = DiaOperator(op.bands.astype(jnp.bfloat16), op.offsets, op.n)
    nbytes_bf = op.bands.size * 2 + 3 * N * 4

    @jax.jit
    def chain_e(bands_bf, v):
        pad = NX
        def body(_, carry):
            vv, s = carry
            vp = jnp.pad(vv, (pad, pad))
            y = jnp.zeros_like(vv)
            for k, off in enumerate(offs):
                y = y + bands_bf[k].astype(jnp.float32) * jax.lax.slice(
                    vp, (pad + off,), (pad + off + N,)) * s
            return y, jax.lax.rsqrt(jnp.vdot(y, y))
        y, s = jax.lax.fori_loop(0, REPS, body, (v, jnp.float32(1.0)))
        return y * s

    t = time_chain(chain_e, opbf.bands, x0)
    results["E_bf16_bands"] = dict(us=t * 1e6, gbs=nbytes_bf / t / 1e9)

    # ---- C2: 2-D + scale-folded --------------------------------------
    @jax.jit
    def chain_c2(bb, v):
        v2 = v.reshape(NX, NX)
        def body(_, carry):
            vv, s = carry
            vp = jnp.pad(vv, ((1, 1), (1, 1)))
            y = jnp.zeros_like(vv)
            for k, off in enumerate(offs):
                dy, dx = coords[int(off)]
                y = y + bb[k] * jax.lax.slice(
                    vp, (1 + dy, 1 + dx), (1 + dy + NX, 1 + dx + NX)) * s
            return y, jax.lax.rsqrt(jnp.vdot(y, y))
        y, s = jax.lax.fori_loop(0, REPS, body, (v2, jnp.float32(1.0)))
        return y * s

    t = time_chain(chain_c2, b2d, x0)
    results["C2_2d_fold"] = dict(us=t * 1e6, gbs=nbytes / t / 1e9)

    # ---- C3: 2-D padded-carry + scale-folded --------------------------
    @jax.jit
    def chain_c3(bb, v):
        vp0 = jnp.pad(v.reshape(NX, NX), ((1, 1), (1, 1)))
        def body(_, carry):
            vp, s = carry
            y = jnp.zeros((NX, NX), dtype=jnp.float32)
            for k, off in enumerate(offs):
                dy, dx = coords[int(off)]
                y = y + bb[k] * jax.lax.slice(
                    vp, (1 + dy, 1 + dx), (1 + dy + NX, 1 + dx + NX)) * s
            s2 = jax.lax.rsqrt(jnp.vdot(y, y))
            vp2 = jnp.zeros_like(vp).at[1:-1, 1:-1].set(y)
            return vp2, s2
        yp, s = jax.lax.fori_loop(0, REPS, body, (vp0, jnp.float32(1.0)))
        return yp * s

    t = time_chain(chain_c3, b2d, x0)
    results["C3_2d_padcarry"] = dict(us=t * 1e6, gbs=nbytes / t / 1e9)

    # ---- C4: 2-D bf16 bands ------------------------------------------
    b2bf = b2d.astype(jnp.bfloat16)

    @jax.jit
    def chain_c4(bb, v):
        v2 = v.reshape(NX, NX)
        def body(_, carry):
            vv, s = carry
            vp = jnp.pad(vv, ((1, 1), (1, 1)))
            y = jnp.zeros_like(vv)
            for k, off in enumerate(offs):
                dy, dx = coords[int(off)]
                y = y + bb[k].astype(jnp.float32) * jax.lax.slice(
                    vp, (1 + dy, 1 + dx), (1 + dy + NX, 1 + dx + NX)) * s
            return y, jax.lax.rsqrt(jnp.vdot(y, y))
        y, s = jax.lax.fori_loop(0, REPS, body, (v2, jnp.float32(1.0)))
        return y * s

    t = time_chain(chain_c4, b2bf, x0)
    results["C4_2d_bf16"] = dict(
        us=t * 1e6, gbs=(op.bands.size * 2 + 3 * N * 4) / t / 1e9)

    # ---- F: padded-carry (no per-rep pad copy), scale-folded ----------
    pad = NX
    xp0 = jnp.pad(x0, (pad, pad))

    @jax.jit
    def chain_f(bands, vp):
        def body(_, carry):
            vv, s = carry
            y = jnp.zeros(N, dtype=jnp.float32)
            for k, off in enumerate(offs):
                y = y + bands[k] * jax.lax.slice(
                    vv, (pad + off,), (pad + off + N,)) * s
            s2 = jax.lax.rsqrt(jnp.vdot(y, y))
            vp2 = jnp.zeros_like(vv).at[pad:pad + N].set(y)
            return vp2, s2
        yp, s = jax.lax.fori_loop(0, REPS, body, (vp, jnp.float32(1.0)))
        return yp * s

    t = time_chain(chain_f, op.bands, xp0)
    results["F_padded_carry"] = dict(us=t * 1e6, gbs=nbytes / t / 1e9)

    for k, v in results.items():
        print(f"{k:16s} {v['us']:8.1f} us  {v['gbs']:7.1f} GB/s(metric)")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
