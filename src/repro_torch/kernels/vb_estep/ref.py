"""Plain PyTorch version of the fused VB E-step.

The same arithmetic as the CUDA kernel, including its digamma: the
8-step shift plus asymptotic series of the TPU kernel
(``src/repro/kernels/vb_estep/vb_estep.py:29-41``), not
``torch.special.digamma``.  The wrapper in ``ops.py`` runs it only for
CPU tensors; on the card it is what the kernel is held against.
"""
from __future__ import annotations

from typing import Tuple

import torch


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
