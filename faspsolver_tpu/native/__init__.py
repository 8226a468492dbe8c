"""Native (C++) setup kernels, loaded through ctypes.

The device solve path is JAX/XLA; the setup phase's irregular graph work
(ILU factorization, coloring, matching, C/F splitting, level scheduling)
is sequential host work — the reference implements it as serial C
(BlaILU.c, BlaSparseCSR.c, PreAMGCoarsenRS.c) and so do we.

The shared library is built on demand with g++ (no pybind11: plain C ABI +
ctypes) from the two tracked sources beside this file.  Its file name
carries a hash of those sources, the compile flags and the host CPU, so a
library built from other sources, with other flags or for another CPU
(``-march=native``) is never loaded: a checkout copied to another machine
builds its own.  Every entry point has a NumPy/SciPy fallback in the
caller, so the framework works without a toolchain; ``available()``
reports status and ``build()`` raises the compiler's error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = (os.path.join(_HERE, "fasp_native.cpp"),
            os.path.join(_HERE, "band_ops.cpp"))
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fopenmp", "-shared",
          "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def host_id() -> str:
    """Machine type plus the CPU's model and feature flags: what
    ``-march=native`` code depends on."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags") and key not in fields:
                    fields[key] = val.strip()
    except OSError:
        pass
    return "|".join([platform.machine(), platform.processor(),
                     fields.get("model name", ""), fields.get("flags", "")])


def lib_tag(sources: Sequence[str] = _SOURCES,
            flags: Sequence[str] = _FLAGS,
            host: Optional[str] = None) -> str:
    """Hash of the sources' bytes, the compile flags and the host."""
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    h.update((host_id() if host is None else host).encode())
    return h.hexdigest()[:16]


def lib_path(tag: str) -> str:
    return os.path.join(_HERE, f"_fasp_native-{tag}.so")


def build() -> str:
    """Path of the library for these sources, flags and host, compiled
    first if it does not exist yet.  Raises the compiler's error."""
    so = lib_path(lib_tag())
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, *_SOURCES, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=240)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build())
        except (OSError, subprocess.SubprocessError):
            return None
        lib.fasp_greedy_color.restype = ctypes.c_int
        lib.fasp_greedy_color.argtypes = [ctypes.c_int, _i32p, _i32p, _i32p]
        lib.fasp_level_schedule.restype = ctypes.c_int
        lib.fasp_level_schedule.argtypes = [ctypes.c_int, _i32p, _i32p,
                                            ctypes.c_int, _i32p]
        lib.fasp_pairwise_match.restype = ctypes.c_int
        lib.fasp_pairwise_match.argtypes = [ctypes.c_int, _i32p, _i32p,
                                            _f64p, _i32p]
        lib.fasp_notay_match.restype = ctypes.c_int
        lib.fasp_notay_match.argtypes = [ctypes.c_int, _i32p, _i32p, _f64p,
                                         ctypes.c_int, ctypes.c_double,
                                         _i32p]
        lib.fasp_nsympair_match.restype = ctypes.c_int
        lib.fasp_nsympair_match.argtypes = [ctypes.c_int, _i32p, _i32p,
                                            _f64p, ctypes.c_int,
                                            ctypes.c_double, _i32p]
        lib.fasp_vmb_aggregate.restype = ctypes.c_int
        lib.fasp_vmb_aggregate.argtypes = [ctypes.c_int, _i32p, _i32p, _f64p,
                                           ctypes.c_int, _i32p]
        lib.fasp_iluk.restype = ctypes.c_int
        lib.fasp_iluk.argtypes = [ctypes.c_int, _i32p, _i32p, _f64p,
                                  ctypes.c_int,
                                  _i32p, _i32p, _f64p, ctypes.c_int64,
                                  _i32p, _i32p, _f64p, ctypes.c_int64]
        lib.fasp_ilut.restype = ctypes.c_int
        lib.fasp_ilut.argtypes = [ctypes.c_int, _i32p, _i32p, _f64p,
                                  ctypes.c_int, ctypes.c_double,
                                  _i32p, _i32p, _f64p, ctypes.c_int64,
                                  _i32p, _i32p, _f64p, ctypes.c_int64]
        lib.fasp_ilutp.restype = ctypes.c_int
        lib.fasp_ilutp.argtypes = [ctypes.c_int, _i32p, _i32p, _f64p,
                                   ctypes.c_int, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_int,
                                   _i32p, _i32p, _f64p, ctypes.c_int64,
                                   _i32p, _i32p, _f64p, ctypes.c_int64,
                                   _i32p]
        lib.fasp_bsr_ilu0.restype = ctypes.c_int
        lib.fasp_bsr_ilu0.argtypes = [ctypes.c_int, ctypes.c_int, _i32p,
                                      _i32p, _f64p, _f64p]
        lib.fasp_rs_cf_split.restype = ctypes.c_int
        lib.fasp_rs_cf_split.argtypes = [ctypes.c_int, _i32p, _i32p,
                                         _i32p, _i32p, _i32p]
        lib.fasp_rs_ff_pass.restype = ctypes.c_int
        lib.fasp_rs_ff_pass.argtypes = [ctypes.c_int, _i32p, _i32p, _i32p]
        lib.fasp_strength_graph.restype = ctypes.c_int64
        lib.fasp_strength_graph.argtypes = [ctypes.c_int, _i32p, _i32p,
                                            _f64p, ctypes.c_double,
                                            ctypes.c_double, _i32p, _i32p]
        lib.fasp_rs_cf_split2.restype = ctypes.c_int
        lib.fasp_rs_cf_split2.argtypes = [ctypes.c_int, _i32p, _i32p, _i32p]
        lib.fasp_interp_std.restype = ctypes.c_int
        lib.fasp_interp_std.argtypes = [ctypes.c_int, _i32p, _i32p, _f64p,
                                        _i32p, _i32p, _i32p, ctypes.c_int,
                                        _i32p, _i32p, _f64p, ctypes.c_int64]
        lib.fasp_fgs_sweeps.restype = ctypes.c_int
        lib.fasp_fgs_sweeps.argtypes = [ctypes.c_int, _i32p, _i32p, _f64p,
                                        _i32p, _f64p, ctypes.c_int]
        _f32p = np.ctypeslib.ndpointer(dtype=np.float32,
                                       flags="C_CONTIGUOUS")
        # band kernels are 3-D only; 2-D calls route through them with nz=1
        for suf, fp in (("f64", _f64p), ("f32", _f32p)):
            mm = getattr(lib, f"fasp_band_matmul_3d_{suf}")
            mm.restype = ctypes.c_int
            mm.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _i32p, fp,
                           ctypes.c_int, _i32p, fp,
                           ctypes.c_int, _i32p, fp]
            rr = getattr(lib, f"fasp_pair_rap_3d_{suf}")
            rr.restype = ctypes.c_int
            rr.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _i32p, fp,
                           ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _i32p, fp]
            ct = ctypes.c_float if suf == "f32" else ctypes.c_double
            sr = getattr(lib, f"fasp_smoothed_rap_3d_{suf}")
            sr.restype = ctypes.c_int
            sr.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _i32p, fp, fp, ct,
                           ctypes.c_int, ctypes.c_int, _i32p, fp]
        _i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
        lib.fasp_rap_symb.restype = ctypes.c_int64
        lib.fasp_rap_symb.argtypes = [ctypes.c_int64] + [_i64p] * 7
        lib.fasp_rap_fill.restype = None
        lib.fasp_rap_fill.argtypes = [ctypes.c_int64,
                                      _i64p, _i64p, _f64p,
                                      _i64p, _i64p, _f64p,
                                      _i64p, _i64p, _f64p,
                                      _i64p, _i64p, _f64p]
        lib.fasp_rap.restype = ctypes.c_int64
        lib.fasp_rap.argtypes = [ctypes.c_int64,
                                 _i64p, _i64p, _f64p,
                                 _i64p, _i64p, _f64p,
                                 _i64p, _i64p, _f64p,
                                 ctypes.c_int64, _i64p, _i64p, _f64p]
        lib.fasp_dia_offsets.restype = ctypes.c_int64
        lib.fasp_dia_offsets.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                         ctypes.c_int64, _i64p]
        lib.fasp_dia_fill_f64.restype = None
        lib.fasp_dia_fill_f64.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                          _f64p, ctypes.c_int64, _i64p,
                                          _f64p]
        lib.fasp_dia_fill_f32.restype = None
        lib.fasp_dia_fill_f32.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                          _f64p, ctypes.c_int64, _i64p,
                                          _f32p]
        lib.fasp_agg_strength.restype = ctypes.c_int64
        lib.fasp_agg_strength.argtypes = [ctypes.c_int, _i32p, _i32p,
                                          _i32p, ctypes.c_int, _i32p,
                                          _i32p, ctypes.c_int64]
        lib.fasp_dia_hist.restype = None
        lib.fasp_dia_hist.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
        lib.fasp_dia_split_f32.restype = ctypes.c_int64
        lib.fasp_dia_split_f32.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                           _f64p, ctypes.c_int64, _i64p,
                                           _f32p, _i32p, _i32p, _f32p,
                                           ctypes.c_int64]
        lib.fasp_dia_split_f64.restype = ctypes.c_int64
        lib.fasp_dia_split_f64.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                           _f64p, ctypes.c_int64, _i64p,
                                           _f64p, _i32p, _i32p, _f64p,
                                           ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _csr_arrays(A) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    return indptr, indices, data, A.shape[0]


def dia_from_csr(A, max_k: int = 128,
                 out_dtype=None) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(offsets, row-aligned (k, n) bands) for a square f64 CSR matrix —
    the OpenMP twin of ops.operators.dia_bands_from_csr.  None when the
    native library is unavailable, the data is not f64, or the extraction
    would be pathological (k > max_k)."""
    lib = _load()
    if lib is None or A.data.dtype != np.float64 or A.nrow != A.ncol \
            or A.nrow == 0:
        return None
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    n = A.nrow
    offs = np.empty(max_k, dtype=np.int64)
    k = int(lib.fasp_dia_offsets(n, indptr, indices, max_k, offs))
    if k < 0 or k > max_k:
        return None
    offs = offs[:k].copy()
    out_dtype = np.dtype(out_dtype) if out_dtype is not None \
        else np.dtype(np.float64)
    bands = np.zeros((k, n), dtype=out_dtype)
    if out_dtype == np.float32:
        lib.fasp_dia_fill_f32(n, indptr, indices, data, k, offs, bands)
    elif out_dtype == np.float64:
        lib.fasp_dia_fill_f64(n, indptr, indices, data, k, offs, bands)
    else:
        return None
    return offs, bands


def dia_hist(A) -> Optional[np.ndarray]:
    """Histogram of diagonal offsets: returns (2n+1,) int64 counts with
    hist[off + n] = #entries on diagonal ``off``, or None without the
    native library.  OpenMP twin of the np.bincount pass in
    ops.operators.best_operator."""
    lib = _load()
    if lib is None or A.data.dtype != np.float64 or A.nrow != A.ncol \
            or A.nrow == 0:
        return None
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    hist = np.zeros(2 * A.nrow + 1, dtype=np.int64)
    lib.fasp_dia_hist(A.nrow, indptr, indices, hist)
    return hist


def dia_split(A, keep_offs: np.ndarray, dtype, nrem: int,
              rem_pad: int) -> Optional[tuple]:
    """Split CSR into row-aligned bands over ``keep_offs`` (ascending)
    plus a COO remainder (CSR order, padded to ``rem_pad`` with
    row=n / col=0 / val=0).  Returns (bands, rem_rows, rem_cols,
    rem_vals) or None without the native library."""
    lib = _load()
    dtype = np.dtype(dtype)
    if lib is None or A.data.dtype != np.float64 \
            or dtype not in (np.float32, np.float64):
        return None
    n = A.nrow
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    keep_offs = np.ascontiguousarray(keep_offs, dtype=np.int64)
    k = len(keep_offs)
    bands = np.zeros((k, n), dtype=dtype)
    pad = max(int(rem_pad), 1)
    rem_rows = np.full(pad, n, dtype=np.int32)
    rem_cols = np.zeros(pad, dtype=np.int32)
    rem_vals = np.zeros(pad, dtype=dtype)
    fn = lib.fasp_dia_split_f32 if dtype == np.float32 \
        else lib.fasp_dia_split_f64
    got = int(fn(n, indptr, indices, data, k, keep_offs, bands,
                 rem_rows, rem_cols, rem_vals, pad))
    if got != nrem:
        return None
    return bands, rem_rows, rem_cols, rem_vals


def rap(R, A, P):
    """Fused Galerkin product C = R A P for general CSR matrices — the
    OpenMP twin of the reference's fasp_blas_dcsr_rap (BlaSpmvCSR.c:999).
    Returns a CSRMatrix with sorted row indices, or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    from ..formats import CSRMatrix

    def _arrs(M):
        return (np.ascontiguousarray(M.indptr, dtype=np.int64),
                np.ascontiguousarray(M.indices, dtype=np.int64),
                np.ascontiguousarray(M.data, dtype=np.float64))

    Rp, Rj, Rx = _arrs(R)
    Ap_, Aj, Ax = _arrs(A)
    Pp, Pj, Px = _arrs(P)
    nc = R.shape[0]
    Cp = np.empty(nc + 1, dtype=np.int64)
    cap = max(int(1.3 * A.nnz) + 8 * nc, 1 << 12)
    for _ in range(3):
        Cj = np.empty(cap, dtype=np.int64)
        Cx = np.empty(cap, dtype=np.float64)
        nnz = int(lib.fasp_rap(nc, Rp, Rj, Rx, Ap_, Aj, Ax, Pp, Pj, Px,
                               cap, Cp, Cj, Cx))
        if nnz >= 0:
            return CSRMatrix(Cp, Cj[:nnz].copy(), Cx[:nnz].copy(),
                             (nc, P.shape[1]))
        cap *= 4
    return None


def greedy_color(indptr, indices, n: int) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load()
    if lib is None:
        return None
    color = np.empty(n, dtype=np.int32)
    nc = lib.fasp_greedy_color(
        n, np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(indices, dtype=np.int32), color)
    return color, int(nc)


def level_schedule(indptr, indices, n: int, lower: bool
                   ) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load()
    if lib is None:
        return None
    depth = np.zeros(n, dtype=np.int32)
    nlev = lib.fasp_level_schedule(
        n, np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(indices, dtype=np.int32),
        1 if lower else 0, depth)
    return depth, int(nlev)


def pairwise_match(A) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load()
    if lib is None:
        return None
    indptr, indices, data, n = _csr_arrays(A.to_scipy())
    agg = np.empty(n, dtype=np.int32)
    nagg = lib.fasp_pairwise_match(n, indptr, indices, data, agg)
    return agg.astype(np.int64), int(nagg)


def notay_match(A, first_pass: bool, k_tg: float
                ) -> Optional[Tuple[np.ndarray, int]]:
    """Quality-bounded symmetric pairwise matching (Notay form_pairwise)."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices, data, n = _csr_arrays(A.to_scipy())
    agg = np.empty(n, dtype=np.int32)
    nagg = lib.fasp_notay_match(n, indptr, indices, data,
                                1 if first_pass else 0, float(k_tg), agg)
    return agg.astype(np.int64), int(nagg)


def nsympair_match(A, first_pass: bool, k_tg: float
                   ) -> Optional[Tuple[np.ndarray, int]]:
    """Non-symmetric pairwise matching (nsympair first-pass rule)."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices, data, n = _csr_arrays(A.to_scipy())
    agg = np.empty(n, dtype=np.int32)
    nagg = lib.fasp_nsympair_match(n, indptr, indices, data,
                                   1 if first_pass else 0, float(k_tg), agg)
    return agg.astype(np.int64), int(nagg)


def vmb_aggregate(S, max_agg: int) -> Optional[Tuple[np.ndarray, int]]:
    """S: scipy strength graph (no diagonal)."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices, data, n = _csr_arrays(S)
    agg = np.empty(n, dtype=np.int32)
    nagg = lib.fasp_vmb_aggregate(n, indptr, indices, data,
                                  int(max_agg), agg)
    return agg.astype(np.int64), int(nagg)


def _ilu_call(fn, A, extra_args, fill_guess: float):
    import scipy.sparse as sp
    m = A.to_scipy().tocsr()
    m.sort_indices()
    indptr, indices, data, n = _csr_arrays(m)
    cap = max(int(m.nnz * fill_guess) + n + 16, 64)
    for _ in range(6):
        l_indptr = np.zeros(n + 1, dtype=np.int32)
        u_indptr = np.zeros(n + 1, dtype=np.int32)
        l_indices = np.empty(cap, dtype=np.int32)
        l_data = np.empty(cap, dtype=np.float64)
        u_indices = np.empty(cap, dtype=np.int32)
        u_data = np.empty(cap, dtype=np.float64)
        rc = fn(n, indptr, indices, data, *extra_args,
                l_indptr, l_indices, l_data, cap,
                u_indptr, u_indices, u_data, cap)
        if rc == 0:
            lnnz = int(l_indptr[n])
            unnz = int(u_indptr[n])
            L = sp.csr_matrix((l_data[:lnnz], l_indices[:lnnz], l_indptr),
                              shape=(n, n))
            U = sp.csr_matrix((u_data[:unnz], u_indices[:unnz], u_indptr),
                              shape=(n, n))
            return L, U
        cap *= 2
    return None


def iluk(A, lfil: int):
    lib = _load()
    if lib is None:
        return None
    return _ilu_call(lib.fasp_iluk, A, (int(lfil),), 2.0 * (lfil + 1))


def ilut(A, lfil: int, droptol: float):
    lib = _load()
    if lib is None:
        return None
    return _ilu_call(lib.fasp_ilut, A, (int(max(lfil, 1)), float(droptol)),
                     3.0)


def ilutp(A, lfil: int, droptol: float, permtol: float = 0.05,
          mbloc: int = 0):
    """ILUtp with column pivoting.  Returns (L, U, perm) where the factors
    satisfy L U ~= A P with U columns in permuted numbering and
    perm[new] = old, or None without a toolchain."""
    import scipy.sparse as sp
    lib = _load()
    if lib is None:
        return None
    m = A.to_scipy().tocsr()
    m.sort_indices()
    indptr, indices, data, n = _csr_arrays(m)
    cap = max(int(m.nnz * 3.0) + n + 16, 64)
    for _ in range(6):
        l_indptr = np.zeros(n + 1, dtype=np.int32)
        u_indptr = np.zeros(n + 1, dtype=np.int32)
        l_indices = np.empty(cap, dtype=np.int32)
        l_data = np.empty(cap, dtype=np.float64)
        u_indices = np.empty(cap, dtype=np.int32)
        u_data = np.empty(cap, dtype=np.float64)
        perm = np.empty(n, dtype=np.int32)
        rc = lib.fasp_ilutp(n, indptr, indices, data,
                            int(max(lfil, 1)), float(droptol),
                            float(permtol), int(mbloc if mbloc > 0 else n),
                            l_indptr, l_indices, l_data, cap,
                            u_indptr, u_indices, u_data, cap, perm)
        if rc == 0:
            lnnz = int(l_indptr[n])
            unnz = int(u_indptr[n])
            L = sp.csr_matrix((l_data[:lnnz], l_indices[:lnnz], l_indptr),
                              shape=(n, n))
            U = sp.csr_matrix((u_data[:unnz], u_indices[:unnz], u_indptr),
                              shape=(n, n))
            return L, U, perm.astype(np.int64)
        cap *= 2
    return None


def bsr_ilu0(indptr, indices, vals, n: int, nb: int):
    """Block ILU(0) in the BSR pattern.  vals (nnzb, nb, nb) is factored
    in place (copy passed in); returns (factored_vals, diaginv) or None."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(vals, dtype=np.float64).copy()
    dinv = np.zeros((n, nb, nb), dtype=np.float64)
    rc = lib.fasp_bsr_ilu0(
        n, nb, np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(indices, dtype=np.int32),
        v.reshape(-1), dinv.reshape(-1))
    if rc != 0:
        return None
    return v, dinv


def rs_cf_split(S) -> Optional[np.ndarray]:
    """Classical RS first-pass C/F splitting.  S: scipy strength CSR."""
    lib = _load()
    if lib is None:
        return None
    ST = S.T.tocsr()
    s_indptr, s_indices, _, n = _csr_arrays(S)
    st_indptr = np.ascontiguousarray(ST.indptr, dtype=np.int32)
    st_indices = np.ascontiguousarray(ST.indices, dtype=np.int32)
    cf = np.empty(n, dtype=np.int32)
    lib.fasp_rs_cf_split(n, s_indptr, s_indices, st_indptr, st_indices, cf)
    return cf


def strength_graph(A, theta: float, max_row_sum: float):
    """Strength CSR (indptr, indices) — data is implicitly all-ones."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices, data, n = _csr_arrays(A.to_scipy())
    s_indptr = np.zeros(n + 1, dtype=np.int32)
    s_indices = np.empty(max(len(indices), 1), dtype=np.int32)
    snnz = lib.fasp_strength_graph(n, indptr, indices, data,
                                   float(theta), float(max_row_sum),
                                   s_indptr, s_indices)
    return s_indptr, s_indices[:snnz]


def agg_strength(s_indptr, s_indices, n: int, cf: np.ndarray,
                 path: int, num_c: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Strength graph Sh between temporary C points for aggressive
    coarsening (reference: strong_couplings_agg1/agg2,
    PreAMGCoarsenRS.c): direct S edge or >= ``path`` distinct 2-hop
    paths through F points.  Returns (sh_indptr, sh_indices) over
    coarse indices, or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    sp_ = np.ascontiguousarray(s_indptr, dtype=np.int32)
    si_ = np.ascontiguousarray(s_indices, dtype=np.int32)
    cf_ = np.ascontiguousarray(cf, dtype=np.int32)
    shp = np.zeros(num_c + 1, dtype=np.int32)
    cap = max(int(si_.size) * 4 + 16 * num_c, 1 << 12)
    for _ in range(3):
        shi = np.empty(cap, dtype=np.int32)
        nnz = int(lib.fasp_agg_strength(n, sp_, si_, cf_, path, shp,
                                        shi, cap))
        if nnz >= 0:
            return shp, shi[:nnz].copy()
        cap *= 4
    return None


def rs_cf_split2(s_indptr, s_indices, n: int) -> Optional[np.ndarray]:
    """Bucket-list classical RS first pass (S^T built internally)."""
    lib = _load()
    if lib is None:
        return None
    cf = np.empty(n, dtype=np.int32)
    lib.fasp_rs_cf_split2(
        n, np.ascontiguousarray(s_indptr, dtype=np.int32),
        np.ascontiguousarray(s_indices, dtype=np.int32), cf)
    return cf


def rs_ff_pass(S, cf: np.ndarray) -> Optional[np.ndarray]:
    """RS pass 2: promote F points whose strong F-F pair shares no C.
    cf: int array (1=C, 0=F, 2=isolated); returns the updated copy."""
    lib = _load()
    if lib is None:
        return None
    s_indptr, s_indices, _, n = _csr_arrays(S)
    out = np.ascontiguousarray(cf, dtype=np.int32).copy()
    lib.fasp_rs_ff_pass(n, s_indptr, s_indices, out)
    return out


def interp_std(A, cf: np.ndarray, S, mode: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Interpolation triplets (rows, coarse cols, vals).
    mode: 0 = standard, 1 = ext+i, 2 = direct."""
    lib = _load()
    if lib is None:
        return None
    m = A.to_scipy().tocsr()
    indptr, indices, data, n = _csr_arrays(m)
    Sr = S.tocsr()
    s_indptr = np.ascontiguousarray(Sr.indptr, dtype=np.int32)
    s_indices = np.ascontiguousarray(Sr.indices, dtype=np.int32)
    cf32 = np.ascontiguousarray(cf, dtype=np.int32)
    cap = max(int(m.nnz * 2) + n + 16, 256)
    for _ in range(6):
        p_rows = np.empty(cap, dtype=np.int32)
        p_cols = np.empty(cap, dtype=np.int32)
        p_vals = np.empty(cap, dtype=np.float64)
        nnz = lib.fasp_interp_std(n, indptr, indices, data, cf32,
                                  s_indptr, s_indices, int(mode),
                                  p_rows, p_cols, p_vals, cap)
        if nnz >= 0:
            return p_rows[:nnz], p_cols[:nnz], p_vals[:nnz]
        cap *= 4
    return None


def fgs_sweeps(A, marker: np.ndarray, e: np.ndarray, sweeps: int
               ) -> Optional[np.ndarray]:
    """F-point GS sweeps on A e = 0 (CR habituation smoother)."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices, data, n = _csr_arrays(A.to_scipy())
    mk = np.ascontiguousarray(marker, dtype=np.int32)
    out = np.ascontiguousarray(e, dtype=np.float64).copy()
    lib.fasp_fgs_sweeps(n, indptr, indices, data, mk, out, int(sweeps))
    return out


def band_matmul_3d(dims, coords_a, bands_a, coords_b, bands_b):
    """Fused band product C = A @ B on a (nz, ny, nx) grid.  bands:
    (k, nz, ny, nx) contiguous; coords: (k, 3) int32.  Returns
    (coords_c, bands_c) or None when no native library is available."""
    lib = _load()
    if lib is None:
        return None
    nz, ny, nx = dims
    # symbolic pass in Python: exact output band count, so the result
    # buffer is exactly sized
    uniq = {tuple(int(a[d]) + int(b[d]) for d in range(3))
            for a in coords_a for b in coords_b}
    max_kc = len(uniq)
    dtype = bands_a.dtype
    fn = (lib.fasp_band_matmul_3d_f32 if dtype == np.float32
          else lib.fasp_band_matmul_3d_f64)
    ca = np.ascontiguousarray(coords_a, dtype=np.int32)
    cb = np.ascontiguousarray(coords_b, dtype=np.int32)
    A = np.ascontiguousarray(bands_a)
    B = np.ascontiguousarray(bands_b.astype(dtype, copy=False))
    cc = np.empty((max_kc, 3), dtype=np.int32)
    C = np.empty((max_kc, nz, ny, nx), dtype=dtype)
    kc = fn(nz, ny, nx, len(ca), ca, A, len(cb), cb, B, max_kc, cc, C)
    if kc < 0:
        return None
    return cc[:kc], C[:kc]


def pair_rap_3d(dims, coords, bands, ax: int, s: int):
    """Fused boolean-grouping Galerkin RAP along one axis of a 3-D grid."""
    lib = _load()
    if lib is None:
        return None
    nz, ny, nx = dims
    uniq = set()
    for c in coords:
        comp = int(c[ax])
        for a in range(s):
            bb = (comp + a) % s
            oc = (comp + a - bb) // s
            cc_ = [int(v) for v in c]
            cc_[ax] = oc
            uniq.add(tuple(cc_))
    max_kc = len(uniq)
    dtype = bands.dtype
    fn = (lib.fasp_pair_rap_3d_f32 if dtype == np.float32
          else lib.fasp_pair_rap_3d_f64)
    cf = np.ascontiguousarray(coords, dtype=np.int32)
    F = np.ascontiguousarray(bands)
    cdims = [nz, ny, nx]
    cdims[ax] = (cdims[ax] + s - 1) // s
    cc = np.empty((max_kc, 3), dtype=np.int32)
    C = np.empty((max_kc, cdims[0], cdims[1], cdims[2]), dtype=dtype)
    kc = fn(nz, ny, nx, len(cf), cf, F, ax, s, max_kc, cc, C)
    if kc < 0:
        return None
    return cc[:kc], C[:kc], tuple(cdims)


def smoothed_rap(dims, coords, bands, dinv, omega: float, s: int):
    """Fused coarse Galerkin product over an nd grid (2-D / 3-D):
    Ac = P^T (I - w A D^-1) A (I - w D^-1 A) P with P the boolean s-per-axis
    grouping aggregation over every axis of extent > 1 (w = 0: plain UA
    RAP).  bands: (k, *dims); coords: (k, nd) int32; dinv: grid array.
    Returns (coarse_coords, coarse_bands (kc, *cdims), cdims) or None."""
    lib = _load()
    if lib is None:
        return None
    nd = len(dims)
    if nd == 2:
        ny, nx = dims
        nz = 1
        k = len(coords)
        cf = np.zeros((k, 3), dtype=np.int32)
        cf[:, 1:] = coords
        bands = bands.reshape(k, 1, ny, nx)
    elif nd == 3:
        nz, ny, nx = dims
        cf = np.ascontiguousarray(coords, dtype=np.int32)
    else:
        return None
    k = len(cf)
    dtype = bands.dtype
    if dtype not in (np.float32, np.float64):
        return None
    # symbolic bound on the coarse band count: coords of M = A + A2 + A3
    # phase-divided by s — mirror of the C++ symbolic pass
    acc = {tuple(int(v) for v in c) for c in cf}
    if float(omega) != 0.0:
        a2 = {tuple(x + y for x, y in zip(c1, c2)) for c1 in acc for c2 in acc}
        a3 = {tuple(x + y for x, y in zip(c1, c2)) for c1 in a2 for c2 in acc}
        mset = acc | a2 | a3
    else:
        mset = acc
    grp = [d > 1 for d in (nz, ny, nx)]
    uniq = set()
    for m in mset:
        for az in range(s if grp[0] else 1):
            for ay in range(s if grp[1] else 1):
                for ax in range(s if grp[2] else 1):
                    uniq.add(tuple(
                        (c + a) // s if g else c
                        for c, a, g in zip(m, (az, ay, ax), grp)))
    max_kc = len(uniq)
    fn = (lib.fasp_smoothed_rap_3d_f32 if dtype == np.float32
          else lib.fasp_smoothed_rap_3d_f64)
    cdims3 = [nz, ny, nx]
    for d in range(3):
        if grp[d]:
            cdims3[d] = (cdims3[d] + s - 1) // s
    F = np.ascontiguousarray(bands)
    dv = np.ascontiguousarray(dinv.reshape(-1), dtype=dtype)
    cc = np.empty((max_kc, 3), dtype=np.int32)
    C = np.empty((max_kc, cdims3[0], cdims3[1], cdims3[2]), dtype=dtype)
    kc = fn(nz, ny, nx, k, cf, F, dv, dtype.type(omega), int(s),
            max_kc, cc, C)
    if kc < 0:
        return None
    if nd == 2:
        return (cc[:kc, 1:], C[:kc].reshape(kc, cdims3[1], cdims3[2]),
                tuple(cdims3[1:]))
    return cc[:kc], C[:kc], tuple(cdims3)


def band_matmul_2d(dims, coords_a, bands_a, coords_b, bands_b):
    """2-D band product: the 3-D kernel with nz = 1, dz = 0."""
    ny, nx = dims
    ka, kb = len(coords_a), len(coords_b)
    ca = np.zeros((ka, 3), dtype=np.int32)
    ca[:, 1:] = coords_a
    cb = np.zeros((kb, 3), dtype=np.int32)
    cb[:, 1:] = coords_b
    out = band_matmul_3d((1, ny, nx), ca,
                         bands_a.reshape(ka, 1, ny, nx), cb,
                         bands_b.reshape(kb, 1, ny, nx))
    if out is None:
        return None
    cc, C = out
    return cc[:, 1:], C.reshape(-1, ny, nx)


def pair_rap_2d(dims, coords, bands, ax: int, s: int):
    """2-D grouping RAP: the 3-D kernel with nz = 1 (axes shift by one)."""
    ny, nx = dims
    k = len(coords)
    cf = np.zeros((k, 3), dtype=np.int32)
    cf[:, 1:] = coords
    out = pair_rap_3d((1, ny, nx), cf, bands.reshape(k, 1, ny, nx),
                      ax + 1, s)
    if out is None:
        return None
    cc, C, cdims3 = out
    return cc[:, 1:], C.reshape(len(cc), cdims3[1], cdims3[2]), cdims3[1:]
