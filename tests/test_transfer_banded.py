"""Gather-frugal banded grid transfers.

The banded P/R (precond/amg/transfer.py BandedProlong/BandedRestrict)
must be EXACT against the CSR P they were built from — they are an
encoding, not an approximation — for every interpolation type and on
both FD and FE hierarchies, including the COO remainder path.

Reference: transfer applies are plain SpMVs inside the MG cycle
(PreMGCycle.c:135-227, BlaSpmvCSR.c:242).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from faspsolver_tpu.constants import CGPT, InterpType
from faspsolver_tpu.precond.amg.coarsen_rs import coarsen
from faspsolver_tpu.precond.amg.interp import interpolate
from faspsolver_tpu.precond.amg.setup_rs import setup_rs, _rap
from faspsolver_tpu.precond.amg.transfer import (BandedProlong,
                                                 banded_transfer,
                                                 csr_transfer)
from faspsolver_tpu.testgen import (assemble_poisson, poisson_2d,
                                    unit_square_mesh)
from faspsolver_tpu.utils.params import AMGParam


def _fe_matrix(n=48):
    mesh = unit_square_mesh(n)
    A, b, _ = assemble_poisson(mesh, lambda p: np.ones(len(p)))
    return A, b


def _hierarchy_ps(A, interp_type=int(InterpType.DIRECT), levels=3):
    """(P, fpos) pairs down a classical RS hierarchy."""
    param = AMGParam(interpolation_type=interp_type)
    out = []
    cur = A
    for _ in range(levels):
        marker, S = coarsen(cur, theta=param.strong_threshold,
                            max_row_sum=param.max_row_sum, method="rs")
        nc = int((marker == CGPT).sum())
        if nc < 2 or nc >= cur.nrow:
            break
        P = interpolate(cur, marker, S, interp_type=interp_type,
                        trunc_threshold=param.truncation_threshold)
        out.append((P, np.flatnonzero(marker == CGPT)))
        cur = _rap(P, cur, P.transpose())
    return out


@pytest.mark.parametrize("interp", [int(InterpType.DIRECT),
                                    int(InterpType.STANDARD),
                                    int(InterpType.ENERGYMIN)])
def test_banded_exact_vs_csr_fe(interp):
    """Banded P/R applies match scipy P @ xc / P.T @ xf exactly on the
    FE hierarchy for every interpolation family."""
    A, _ = _fe_matrix(48)
    rng = np.random.default_rng(7)
    engaged = 0
    for P, fpos in _hierarchy_ps(A, interp):
        bt = banded_transfer(P, fpos, dtype=jnp.float64)
        if bt is None:
            continue
        engaged += 1
        Pop, Rop = bt
        xc = rng.standard_normal(P.shape[1])
        xf = rng.standard_normal(P.shape[0])
        sp = P.to_scipy()
        np.testing.assert_allclose(np.asarray(Pop(jnp.asarray(xc))),
                                   sp @ xc, rtol=0, atol=1e-13)
        np.testing.assert_allclose(np.asarray(Rop(jnp.asarray(xf))),
                                   sp.T @ xf, rtol=0, atol=1e-13)
    assert engaged >= 1, "banded path must engage on the FE hierarchy"


def test_banded_engages_on_fine_fd_level():
    """The 2D FD Poisson fine-level P band-compresses with a handful of
    shifts and an empty remainder — the case that was 70% of cycle time
    as COO gathers."""
    A = poisson_2d(63)
    (P, fpos), *_ = _hierarchy_ps(A)
    bt = banded_transfer(P, fpos, dtype=jnp.float64)
    assert bt is not None
    Pop, _ = bt
    assert len(Pop.shifts) <= 12
    rng = np.random.default_rng(0)
    xc = rng.standard_normal(P.shape[1])
    np.testing.assert_allclose(np.asarray(Pop(jnp.asarray(xc))),
                               P.to_scipy() @ xc, rtol=0, atol=1e-13)


def test_banded_remainder_path():
    """Entries not on a kept shift ride the COO remainder exactly: force
    a tiny max_shifts so the remainder is non-empty."""
    A, _ = _fe_matrix(32)
    (P, fpos), *_ = _hierarchy_ps(A)
    bt = banded_transfer(P, fpos, dtype=jnp.float64, max_shifts=2,
                         max_rem_frac=1.0)
    assert bt is not None
    Pop, Rop = bt
    assert Pop.has_rem
    rng = np.random.default_rng(3)
    xc = rng.standard_normal(P.shape[1])
    xf = rng.standard_normal(P.shape[0])
    sp = P.to_scipy()
    np.testing.assert_allclose(np.asarray(Pop(jnp.asarray(xc))),
                               sp @ xc, rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(Rop(jnp.asarray(xf))),
                               sp.T @ xf, rtol=0, atol=1e-13)


def test_banded_declines_on_random_p():
    """A random-permutation P (no grid geometry) must NOT band-compress —
    the builder returns None and callers fall back to COO."""
    import scipy.sparse as sp
    from faspsolver_tpu.formats import CSRMatrix
    rng = np.random.default_rng(11)
    nf, nc = 4096, 1024
    rows = np.arange(nf)
    cols = rng.integers(0, nc, size=nf)
    M = sp.csr_matrix((rng.standard_normal(nf), (rows, cols)),
                      shape=(nf, nc))
    P = CSRMatrix.from_scipy(M)
    fpos = rng.permutation(nf)[:nc]
    assert banded_transfer(P, fpos, dtype=jnp.float64,
                           max_rem_frac=0.05) is None


def test_setup_rs_iteration_parity_banded_vs_coo(monkeypatch):
    """The banded transfers are an encoding change only: forcing the COO
    fallback must give the identical AMG-PCG iteration count."""
    from faspsolver_tpu.krylov import pcg
    from faspsolver_tpu.ops import device_operator
    from faspsolver_tpu.precond import AMGPrecond

    A, b = _fe_matrix(40)

    def run(force_coo):
        if force_coo:
            import importlib
            m = importlib.import_module(
                "faspsolver_tpu.precond.amg.setup_rs")
            monkeypatch.setattr(m, "banded_transfer",
                                lambda *a, **k: None)
        hier = setup_rs(A, AMGParam(), dtype=jnp.float64)
        op = device_operator(A, dtype=jnp.float64)
        res = pcg(op, jnp.asarray(b), M=AMGPrecond(hier), tol=1e-8,
                  maxit=60)
        return int(res.iters), float(res.relres)

    it_banded, rr_banded = run(False)
    it_coo, rr_coo = run(True)
    assert it_banded == it_coo
    assert rr_banded < 1e-8 and rr_coo < 1e-8


def test_banded_survives_packing():
    """Banded transfers pack/unpack through the flat-buffer freeze with
    shared P/R arrays deduplicated (ops/packing.py)."""
    import jax
    from faspsolver_tpu.ops.packing import pack_pytree
    from faspsolver_tpu.ops.operators import defer_device

    A, _ = _fe_matrix(32)
    with defer_device():
        hier = setup_rs(A, AMGParam(), dtype=jnp.float64)
    packed = pack_pytree(hier, np.float64)
    assert packed is not None
    hier_dev = jax.jit(lambda: packed.unpack())()
    lvl = hier_dev.levels[0]
    if not isinstance(lvl.P, BandedProlong):
        pytest.skip("fine level fell back to COO on this mesh")
    rng = np.random.default_rng(5)
    xc = rng.standard_normal(lvl.P.shape[1])
    y = np.asarray(lvl.P(jnp.asarray(xc)))
    # ground truth straight off the host banded data
    Pref = hier.levels[0].P
    nf = Pref.n_fine
    xe = np.zeros(nf)
    xe[np.asarray(Pref.fpos)] = xc
    yref = np.zeros(nf)
    if Pref.const_mode:
        from faspsolver_tpu.ops.operators import unpack_bits_np
        wc = np.asarray(Pref.wc)
        wm = np.asarray(Pref.wm)
        w = np.stack([wc[k] * unpack_bits_np(wm[k], nf)
                      for k in range(len(Pref.shifts))])
    else:
        w = np.asarray(Pref.w)
    for k, s in enumerate(Pref.shifts):
        src = np.zeros(nf)                 # src[i] = xe[i + s]
        if s >= 0:
            src[:nf - s] = xe[s:]
        else:
            src[-s:] = xe[:nf + s]
        yref += w[k] * src
    if Pref.has_rem:
        rr = np.asarray(Pref.rem_rows)
        rc = np.asarray(Pref.rem_cols)
        rv = np.asarray(Pref.rem_vals)
        sel = rr < nf
        np.add.at(yref, rr[sel], rv[sel] * xc[rc[sel]])
    np.testing.assert_allclose(y, yref, rtol=0, atol=1e-12)
