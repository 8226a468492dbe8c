"""Host-side BSR (block compressed sparse row) container.

Reference: base/include/fasp_block.h:34-66 dBSRmat (MKL-style), container ops
in base/src/BlaSparseBSR.c.  Block values are stored as a dense (NNZ, nb, nb)
array — directly consumable by vmapped/batched device kernels (the device
equivalent of the reference's hand-unrolled nb∈{2,3,5,7} loops in
BlaSpmvBSR.c:301-412 is a batched dot over the trailing (nb, nb) axes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ..constants import ERROR_DATA_STRUCTURE
from ..utils.errors import FaspError
from .csr import CSRMatrix


@dataclass
class BSRMatrix:
    indptr: np.ndarray    # (ROW+1,) block-row pointers
    indices: np.ndarray   # (NNZ,)   block-column indices
    data: np.ndarray      # (NNZ, nb, nb) row-major blocks
    shape: Tuple[int, int]  # block shape: (ROW, COL)

    def __post_init__(self):
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int64)
        self.data = np.ascontiguousarray(self.data)
        if self.data.ndim != 3 or self.data.shape[1] != self.data.shape[2]:
            raise FaspError(ERROR_DATA_STRUCTURE, "BSR blocks must be (nnz,nb,nb)")

    @property
    def nb(self) -> int:
        return self.data.shape[1]

    @property
    def nrow_block(self) -> int:
        return self.shape[0]

    @property
    def ncol_block(self) -> int:
        return self.shape[1]

    @property
    def nnz_block(self) -> int:
        return len(self.indices)

    @property
    def nrow(self) -> int:
        return self.shape[0] * self.nb

    @property
    def dtype(self):
        return self.data.dtype

    # -- conversions (reference: BlaFormat.c fasp_format_dbsr_dcsr etc.) ----

    def to_scipy(self) -> sp.bsr_matrix:
        nb = self.nb
        return sp.bsr_matrix((self.data, self.indices, self.indptr),
                             shape=(self.shape[0] * nb, self.shape[1] * nb))

    def to_csr(self) -> CSRMatrix:
        return CSRMatrix.from_scipy(self.to_scipy().tocsr())

    @classmethod
    def from_csr(cls, A: CSRMatrix, nb: int) -> "BSRMatrix":
        m = sp.bsr_matrix(A.to_scipy(), blocksize=(nb, nb))
        return cls(m.indptr, m.indices, m.data,
                   (m.shape[0] // nb, m.shape[1] // nb))

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self.to_scipy() @ x

    # -- block-diagonal ops (reference: BlaSparseBSR.c fasp_dbsr_getdiaginv) --

    def diag_blocks(self) -> np.ndarray:
        """Extract the (ROW, nb, nb) diagonal blocks."""
        out = np.zeros((self.shape[0], self.nb, self.nb), dtype=self.dtype)
        for i in range(self.shape[0]):
            s, e = self.indptr[i], self.indptr[i + 1]
            hit = np.nonzero(self.indices[s:e] == i)[0]
            if hit.size:
                out[i] = self.data[s + hit[0]]
        return out

    def diag_inv(self) -> np.ndarray:
        """Precomputed block-diagonal inverses (reference: fasp_dbsr_getdiaginv)
        — feeds the BSR Jacobi/GS smoothers."""
        return np.linalg.inv(self.diag_blocks())

    def condense(self, norm_type: int = -1) -> CSRMatrix:
        """Condense each block to a scalar for aggregation on the blocks'
        graph (reference: condenseBSR / condenseBSRLinf,
        PreAMGAggregationBSR.inl:20-120).

        norm_type <0: signed Frobenius norm; otherwise signed L-inf norm
        of the block (condenseBSRLinf).  Both follow the reference's sign
        convention — off-diagonal blocks negative, diagonal positive — so
        M-matrix strength-of-connection logic applies to the condensed
        graph (PreAMGAggregationBSR.inl:114: ``if (i != j) Aval = -Aval``).
        """
        if norm_type >= 0:
            # L-inf matrix norm = max absolute ROW SUM of the block
            # (fasp_smat_Linf, BlaSmallMatInv.c:646)
            vals = np.abs(self.data).sum(axis=2).max(axis=1)
        else:
            vals = np.linalg.norm(self.data, axis=(1, 2))
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        vals = np.where(rows == self.indices, vals, -vals)
        return CSRMatrix.from_coo(rows, self.indices, vals,
                                  (self.shape[0], self.shape[1]))
