"""CSRL container: CSR with rows grouped by equal nonzero count.

Reference: dCSRLmat (fasp.h:277-306) — rows of the same length stored
contiguously so inner loops vectorize.  On the device the padded-ELL
operator is this idea taken to its conclusion; CSRL remains useful as a
host-side staging format: each group is a dense (nrows, len) block that
can be fed to batched kernels with zero padding waste.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .csr import CSRMatrix


@dataclass
class CSRLMatrix:
    ncol: int
    groups: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]
    # per group: (row_len, row_ids (g,), cols (g, len), vals (g, len))

    @property
    def nrow(self) -> int:
        return sum(len(g[1]) for g in self.groups)

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def nnz(self) -> int:
        return sum(g[2].size for g in self.groups)

    @classmethod
    def from_csr(cls, A: CSRMatrix) -> "CSRLMatrix":
        lens = A.row_nnz()
        groups = []
        for ln in np.unique(lens):
            rows = np.nonzero(lens == ln)[0]
            if ln == 0:
                groups.append((0, rows,
                               np.zeros((len(rows), 0), dtype=np.int64),
                               np.zeros((len(rows), 0))))
                continue
            cols = np.empty((len(rows), ln), dtype=np.int64)
            vals = np.empty((len(rows), ln))
            for k, r in enumerate(rows):
                s, e = A.indptr[r], A.indptr[r + 1]
                cols[k] = A.indices[s:e]
                vals[k] = A.data[s:e]
            groups.append((int(ln), rows, cols, vals))
        return cls(ncol=A.ncol, groups=groups)

    def to_csr(self) -> CSRMatrix:
        n = self.nrow
        lens = np.zeros(n, dtype=np.int64)
        for ln, rows, _, _ in self.groups:
            lens[rows] = ln
        indptr = np.concatenate([[0], np.cumsum(lens)])
        indices = np.empty(indptr[-1], dtype=np.int64)
        data = np.empty(indptr[-1])
        for ln, rows, cols, vals in self.groups:
            for k, r in enumerate(rows):
                indices[indptr[r]:indptr[r + 1]] = cols[k]
                data[indptr[r]:indptr[r + 1]] = vals[k]
        return CSRMatrix(indptr, indices, data, (n, self.ncol))

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Group-blocked SpMV (reference: fasp_blas_dcsrl_mxv,
        BlaSpmvCSRL.c) — each group is one dense gather+reduce."""
        y = np.zeros(self.nrow)
        for ln, rows, cols, vals in self.groups:
            if ln:
                y[rows] = np.einsum("gk,gk->g", vals, x[cols])
        return y
