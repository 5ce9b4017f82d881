"""CSR form of a dense doc-term matrix: the E-step kernel's input.

``doc_term_csr`` turns a (D, V) float32 matrix on any device into its
nonzeros sorted by (document, term) — ``indptr``, ``indices``, ``values``
and ``rows`` (the document of each entry) — and a column view of the
same entries ordered by (term, document): ``col_ptr`` and ``perm`` (the
CSR position of each entry in column order).  It is bookkeeping built
from torch index operations (a count, ``nonzero_static``, ``cumsum``,
a stable sort, ``searchsorted``), not the E-step's arithmetic, and it
synchronises with the device once: the host needs the number of
nonzeros to size the arrays and the longest row to plan the kernel.
``core.vb.vb_fit`` builds it once per fit and reuses it for every E-step
call.

``doc_term_csr_from_tokens`` builds the same CSR, field for field, from
a window's tokens (the ``Corpus`` arrays ``doc_ids`` and ``tokens``)
without the dense matrix: a sorted ``unique`` of the (document, term)
keys gives the entries in row-major order and their counts, and
``searchsorted`` gives the row and column offsets.  It does
O(tokens · log tokens) work on the tokens' device where the dense route
makes and scans D · V floats.
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
    col_ptr, perm = _column_view(cols, v)
    return DocTermCSR(
        indptr=indptr, indices=cols.to(torch.int32),
        values=x[rows, cols].to(torch.float32), rows=rows.to(torch.int32),
        col_ptr=col_ptr, perm=perm, shape=(d, v), max_row=int(max_row))


def _column_view(cols: torch.Tensor, v: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(col_ptr, perm), int32, of entries in (document, term) order whose
    terms are ``cols``; no synchronisation (``bincount`` would read the
    largest term back)."""
    # rows ascend within each column, so a stable sort by term keeps
    # every column in document order
    perm = torch.sort(cols, stable=True).indices
    col_ptr = torch.searchsorted(
        cols[perm], torch.arange(v + 1, device=cols.device))
    return col_ptr.to(torch.int32), perm.to(torch.int32)


def doc_term_csr_from_tokens(doc_ids: torch.Tensor, tokens: torch.Tensor,
                             n_docs: int, vocab_size: int) -> DocTermCSR:
    """``doc_term_csr`` of the (n_docs, vocab_size) count matrix of the
    tokens, built from the tokens on their device.

    ``doc_ids`` and ``tokens`` (T,) integer tensors on one device: the
    document (window-relative) and the term of every token, in any
    order.  A document with no tokens is an empty row.  Raises
    ``ValueError`` for a document outside [0, n_docs) or a term outside
    [0, vocab_size).  It synchronises twice: ``unique`` sizes its output,
    then the longest row and the range check are read together.
    """
    if doc_ids.dim() != 1 or doc_ids.shape != tokens.shape:
        raise ValueError(f"doc_ids and tokens must be (T,) alike, got "
                         f"{tuple(doc_ids.shape)} and {tuple(tokens.shape)}")
    if doc_ids.device != tokens.device:
        raise ValueError(f"doc_ids on {doc_ids.device}, tokens on "
                         f"{tokens.device}")
    d, v = int(n_docs), int(vocab_size)
    dev = tokens.device
    doc, term = doc_ids.to(torch.int64), tokens.to(torch.int64)
    # int64 keys: a gap of 300k documents at V = 102,660 passes 2**31
    stride = max(v, 1)
    keys = doc * stride + term
    bad = ((doc < 0) | (doc >= d) | (term < 0) | (term >= v)).any()
    # first synchronisation: the number of distinct (doc, term) pairs;
    # sorted keys are the entries in (d, v) order, and what follows is
    # index arithmetic that no out-of-range key can fault
    keys, counts = torch.unique(keys, sorted=True, return_counts=True)
    rows = torch.div(keys, stride, rounding_mode="floor")
    cols = keys - rows * stride
    indptr = torch.searchsorted(
        rows, torch.arange(d + 1, device=dev)).to(torch.int32)
    col_ptr, perm = _column_view(cols, v)
    longest = (indptr.diff().max() if d
               else torch.zeros((), dtype=torch.int32, device=dev))
    # second synchronisation: the kernel plan's longest row, and the check
    max_row, n_bad = torch.stack([longest.to(torch.int64),
                                  bad.to(torch.int64)]).tolist()
    if n_bad:
        raise ValueError(f"a token outside [0, {v}) or a document outside "
                         f"[0, {d})")
    return DocTermCSR(
        indptr=indptr, indices=cols.to(torch.int32),
        values=counts.to(torch.float32), rows=rows.to(torch.int32),
        col_ptr=col_ptr, perm=perm, shape=(d, v), max_row=int(max_row))
