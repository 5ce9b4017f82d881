"""CSR form of a dense doc-term matrix: the E-step kernel's input.

``doc_term_csr`` turns a (D, V) float32 matrix on any device into its
nonzeros sorted by (document, term) — ``indptr``, ``indices``, ``values``
and ``rows`` (the document of each entry) — and a column view of the
same entries ordered by (term, document): ``col_ptr`` and ``perm`` (the
CSR position of each entry in column order).  It is bookkeeping built
from torch index operations (a count, ``nonzero_static``, ``cumsum``,
``bincount``, a stable sort), not the E-step's arithmetic, and it
synchronises with the device once: the host needs the number of
nonzeros to size the arrays and the longest row to plan the kernel.
``core.vb.vb_fit`` builds it once per fit and reuses it for every E-step
call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class DocTermCSR:
    indptr: torch.Tensor    # (D + 1,) int32, row offsets
    indices: torch.Tensor   # (nnz,) int32, term of each entry
    values: torch.Tensor    # (nnz,) float32, count of each entry
    rows: torch.Tensor      # (nnz,) int32, document of each entry
    col_ptr: torch.Tensor   # (V + 1,) int32, column offsets into perm
    perm: torch.Tensor      # (nnz,) int32, CSR position, in (term, doc) order
    shape: Tuple[int, int]  # (D, V)
    max_row: int            # most nonzeros in one document

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def device(self) -> torch.device:
        return self.values.device


def doc_term_csr(x: torch.Tensor) -> DocTermCSR:
    """CSR rows and column view of the nonzeros of ``x`` (D, V)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (D, V), got {tuple(x.shape)}")
    d, v = x.shape
    dev = x.device
    mask = x != 0
    counts = mask.sum(1)
    # the one synchronisation: sizes for the arrays and the kernel plan
    nnz, max_row = (torch.stack([counts.sum(), counts.max()]).tolist()
                    if d else (0, 0))
    nz = torch.nonzero_static(mask, size=nnz)    # row-major: (d, v) order
    rows, cols = nz[:, 0], nz[:, 1]
    indptr = torch.zeros(d + 1, dtype=torch.int32, device=dev)
    indptr[1:] = counts.cumsum(0)
    col_ptr = torch.zeros(v + 1, dtype=torch.int32, device=dev)
    col_ptr[1:] = torch.bincount(cols, minlength=v).cumsum(0)
    # rows ascend within each column, so a stable sort by term keeps
    # every column in document order
    perm = torch.sort(cols, stable=True).indices
    return DocTermCSR(
        indptr=indptr, indices=cols.to(torch.int32),
        values=x[rows, cols].to(torch.float32), rows=rows.to(torch.int32),
        col_ptr=col_ptr, perm=perm.to(torch.int32), shape=(d, v),
        max_row=int(max_row))
