"""Batch mean-field Variational Bayes for LDA (Hoffman-style), in PyTorch.

The E-step inner loop is two products per iteration over the doc-term
matrix — LDA's compute hot spot.  ``use_kernel=True`` routes it through
the sparse E-step's wrapper (``kernels/vb_estep``), which launches the
CUDA kernel for CUDA tensors and runs its plain version for CPU ones;
``vb_fit`` then converts x to CSR once per fit (one synchronisation) and
every E-step call of the fit reuses it.  The plain path here is the
counterpart of the JAX package's jnp path and takes CPU tensors only: on
the card the E-step is the kernel.

Randomness comes from an explicit ``torch.Generator``; the trainer
runs on ``gen.device``.  ``lam0=`` injects the initial λ so a test can
hand the JAX and PyTorch trainers the same starting point.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.lda_default import LDAConfig


def _exp_dirichlet_expectation(x: torch.Tensor) -> torch.Tensor:
    """exp(E[log p]) for Dirichlet rows: exp(ψ(x) − ψ(Σx))."""
    return torch.exp(torch.special.digamma(x)
                     - torch.special.digamma(x.sum(-1, keepdim=True)))


def vb_estep(x: torch.Tensor, exp_elog_beta: torch.Tensor,
             gamma0: torch.Tensor, alpha: float, n_iters: int,
             *, use_kernel: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coordinate-ascent E-step over a doc-block.

    x:              (D, V) counts, f32
    exp_elog_beta:  (K, V) f32
    gamma0:         (D, K) f32 initial document-topic Dirichlet params
    Returns (gamma, sstats) with sstats (K, V) = Σ_d n_dw φ_dwk
    (already multiplied by expElogbeta).
    """
    if use_kernel:
        from repro_torch.kernels.vb_estep import ops as _ops
        return _ops.vb_estep(x, exp_elog_beta, gamma0, alpha, n_iters)
    for t in (x, exp_elog_beta, gamma0):
        if t.device.type != "cpu":
            raise ValueError(
                f"the plain E-step takes CPU tensors only, got one on "
                f"{t.device}; pass use_kernel=True to run the kernel")

    gamma = gamma0
    for _ in range(n_iters):
        exp_elog_theta = _exp_dirichlet_expectation(gamma)   # (D, K)
        phinorm = exp_elog_theta @ exp_elog_beta + 1e-30     # (D, V)
        gamma = alpha + exp_elog_theta * ((x / phinorm) @ exp_elog_beta.T)
    exp_elog_theta = _exp_dirichlet_expectation(gamma)
    phinorm = exp_elog_theta @ exp_elog_beta + 1e-30
    sstats = (exp_elog_theta.T @ (x / phinorm)) * exp_elog_beta
    return gamma, sstats


def vb_fit(x: Union[np.ndarray, torch.Tensor], gen: torch.Generator,
           cfg: LDAConfig, *, use_kernel: bool = False,
           lam0: Optional[Union[np.ndarray, torch.Tensor]] = None
           ) -> torch.Tensor:
    """Batch VB on a dense doc-term matrix.  Returns λ (K, V) f32 on
    ``gen.device``.

    λ0 = Gamma(100)·0.01, drawn from ``gen`` unless ``lam0`` is given.
    """
    dev = gen.device
    x = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
    k = cfg.n_topics
    d, v = x.shape
    if lam0 is None:
        lam = torch._standard_gamma(
            torch.full((k, v), 100.0, dtype=torch.float32, device=dev),
            generator=gen) * 0.01
    else:
        lam = (lam0 if isinstance(lam0, torch.Tensor)
               else torch.from_numpy(np.array(lam0, np.float32)))
        lam = lam.to(dev, torch.float32)
        if lam.shape != (k, v):
            raise ValueError(f"lam0 must be ({k}, {v}), got "
                             f"{tuple(lam.shape)}")
    gamma0 = torch.ones((d, k), dtype=torch.float32, device=dev)
    if use_kernel:
        from repro_torch.kernels.vb_estep import ops as _ops
        csr = _ops.doc_term_csr(x)       # its one sync stays out of the loop

        def estep(eeb):
            return _ops.vb_estep_csr(csr, eeb, gamma0, cfg.alpha,
                                     cfg.e_step_iters)
    else:
        def estep(eeb):
            return vb_estep(x, eeb, gamma0, cfg.alpha, cfg.e_step_iters)
    for _ in range(cfg.max_iters):
        _, sstats = estep(_exp_dirichlet_expectation(lam))
        lam = cfg.eta + sstats
    return lam
