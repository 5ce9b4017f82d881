"""Plain PyTorch versions of the VB E-step, dense and sparse (CSR).

The same arithmetic as the CUDA kernel, including its digamma: the
8-step shift plus asymptotic series of the TPU kernel
(``src/repro/kernels/vb_estep/vb_estep.py:29-41``), not
``torch.special.digamma``.  ``vb_estep_csr_ref`` is the CPU path of the
CSR wrapper in ``ops.py``; the dense ``vb_estep_ref`` is the yardstick
the kernel is held against on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.vb_estep.csr import DocTermCSR


def digamma_series(x: torch.Tensor) -> torch.Tensor:
    """ψ(x) for x > 0 — recurrence shift to x >= 8, then asymptotic."""
    shift = torch.zeros_like(x)
    for _ in range(8):
        small = x < 8.0
        shift = shift - torch.where(small, 1.0 / x, torch.zeros_like(x))
        x = torch.where(small, x + 1.0, x)
    inv = 1.0 / x
    inv2 = inv * inv
    # ψ(x) ≈ ln x − 1/(2x) − 1/(12x²) + 1/(120x⁴) − 1/(252x⁶)
    series = (torch.log(x) - 0.5 * inv
              - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)))
    return series + shift


def exp_dirichlet_series(g: torch.Tensor) -> torch.Tensor:
    """exp(ψ(g) − ψ(Σg)) per row, with the series ψ."""
    return torch.exp(digamma_series(g)
                     - digamma_series(g.sum(-1, keepdim=True)))


def vb_estep_ref(x: torch.Tensor, exp_elog_beta: torch.Tensor,
                 gamma0: torch.Tensor, alpha: float, n_iters: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (D, V); exp_elog_beta: (K, V); gamma0: (D, K).

    Returns (gamma (D, K), sstats (K, V)).
    """
    gamma = gamma0
    for _ in range(n_iters):
        ee_theta = exp_dirichlet_series(gamma)
        phinorm = ee_theta @ exp_elog_beta + 1e-30
        gamma = alpha + ee_theta * ((x / phinorm) @ exp_elog_beta.T)
    ee_theta = exp_dirichlet_series(gamma)
    phinorm = ee_theta @ exp_elog_beta + 1e-30
    sstats = (ee_theta.T @ (x / phinorm)) * exp_elog_beta
    return gamma, sstats


def vb_estep_csr_ref(csr: DocTermCSR, exp_elog_beta: torch.Tensor,
                     gamma0: torch.Tensor, alpha: float, n_iters: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The E-step over the nonzeros of x only: gathers and ``index_add_``.

    An entry with x = 0 adds exactly 0 to γ and to the sstats of the
    dense form, so this is ``vb_estep_ref`` with the sums reordered.
    """
    rows, cols = csr.rows.long(), csr.indices.long()
    b = exp_elog_beta.t()[cols]                     # (nnz, K): eeβ[:, v_j]
    gamma = gamma0
    for it in range(n_iters + 1):
        ee_theta = exp_dirichlet_series(gamma)
        phinorm = (ee_theta[rows] * b).sum(1) + 1e-30
        ratio = csr.values / phinorm
        if it == n_iters:
            break
        gamma = alpha + ee_theta * torch.zeros_like(gamma).index_add_(
            0, rows, ratio[:, None] * b)
    sstats = torch.zeros_like(exp_elog_beta).index_add_(
        1, cols, (ee_theta[rows] * ratio[:, None]).t()) * exp_elog_beta
    return gamma, sstats
