"""Batch mean-field Variational Bayes for LDA (Hoffman-style), in PyTorch.

The E-step inner loop is two products per iteration over the doc-term
matrix — LDA's compute hot spot.  ``use_kernel=True`` routes it through
the sparse E-step's wrapper (``kernels/vb_estep``), which launches the
CUDA kernel for CUDA tensors and runs its plain version for CPU ones;
``vb_fit`` then converts x to CSR once per fit and every E-step call of
the fit reuses it, or takes a CSR already built on the device (the
device backend builds a window's from its tokens).  The plain path here
is the counterpart of the JAX package's jnp path and takes CPU tensors
only: on the card the E-step is the kernel.

Randomness comes from an explicit ``torch.Generator``; the trainer
runs on ``gen.device``.  ``lam0=`` injects the initial λ so a test can
hand the JAX and PyTorch trainers the same starting point.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.lda_default import LDAConfig
from repro_torch.distributed.sharding import MeshEnv, all_reduce
from repro_torch.kernels.vb_estep.csr import DocTermCSR
from repro_torch.obs import trace as obs


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


def _initial_lambda(gen: torch.Generator, k: int, v: int,
                    lam0: Optional[Union[np.ndarray, torch.Tensor]]
                    ) -> torch.Tensor:
    """``lam0`` as (K, V) float32, or a Gamma(100)·0.01 draw from ``gen``
    on ``gen.device``."""
    if lam0 is None:
        return torch._standard_gamma(
            torch.full((k, v), 100.0, dtype=torch.float32,
                       device=gen.device), generator=gen) * 0.01
    lam = (lam0 if isinstance(lam0, torch.Tensor)
           else torch.from_numpy(np.array(lam0, np.float32)))
    if lam.shape != (k, v):
        raise ValueError(f"lam0 must be ({k}, {v}), got {tuple(lam.shape)}")
    return lam.to(torch.float32)


def vb_fit(x: Union[np.ndarray, torch.Tensor, DocTermCSR],
           gen: torch.Generator, cfg: LDAConfig, *, use_kernel: bool = False,
           lam0: Optional[Union[np.ndarray, torch.Tensor]] = None
           ) -> torch.Tensor:
    """Batch VB on a dense doc-term matrix, or on its CSR already on
    ``gen.device`` (the E-step kernel's input: ``use_kernel=True`` only;
    nothing is uploaded or built).  Returns λ (K, V) f32 on
    ``gen.device``.

    λ0 = Gamma(100)·0.01, drawn from ``gen`` unless ``lam0`` is given.
    """
    dev = gen.device
    if isinstance(x, DocTermCSR):
        if not use_kernel:
            raise ValueError("a DocTermCSR is the E-step kernel's input: "
                             "pass use_kernel=True")
        csr = x
        d, v = csr.shape
    else:
        x = torch.as_tensor(x, dtype=torch.float32)
        with obs.span("train.upload", "train",
                      bytes=x.numel() * x.element_size()):
            x = x.to(dev).contiguous()
        csr = None
        d, v = x.shape
    k = cfg.n_topics
    lam = _initial_lambda(gen, k, v, lam0).to(dev)
    gamma0 = torch.ones((d, k), dtype=torch.float32, device=dev)
    with obs.span("train.fit", "train", iters=cfg.max_iters):
        if use_kernel:
            from repro_torch.kernels.vb_estep import ops as _ops
            if csr is None:   # its sync stays out of the loop
                csr = _ops.doc_term_csr(x)

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


# ---------------------------------------------------------------------------
# sharded training: documents over "data", vocabulary over "model"
# ---------------------------------------------------------------------------

def vb_fit_sharded(x: Union[np.ndarray, torch.Tensor], gen: torch.Generator,
                   cfg: LDAConfig, env: MeshEnv,
                   max_iters: Optional[int] = None, *,
                   lam0: Optional[Union[np.ndarray, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Distributed batch VB over ``env``'s grid.  Returns λ (K, V) f32 on
    ``env.first``.

    x (D, V) splits into contiguous row blocks over the data ranks and
    column blocks over the model shards; cell (d, m) holds its block and
    the λ columns of shard m.  Each outer iteration:
      - the Dirichlet expectation of a column-split λ needs the *global*
        row sums — one (K, 1) sum over the model shards;
      - phinorm needs only local columns (its sum runs over K);
      - each E-step iteration's γ update sums over V — one (D_d, K) sum
        of the shards' partial products;
      - the λ update sums over documents — one (K, V_m) sum of the data
        ranks' sstats: the paper's Alg. 1 merge of per-partition models.
    Every sum is ``sharding.all_reduce`` (grid order, same bits every
    run).  The E-step is plain torch, as it is ``jnp`` in the JAX
    package: a cell holds only part of V, so the fused kernel, whose
    γ update needs every column, does not apply.

    λ0: ``lam0`` when given, else one (K, V) Gamma(100)·0.01 draw from
    ``gen`` on ``gen.device`` — the draw ``vb_fit`` makes from the same
    generator state — split into the shards' columns.  (The JAX package
    draws every shard's slice from one key, so its sharded and unsharded
    fits start apart.)
    """
    iters = max_iters if max_iters is not None else cfg.max_iters
    k = cfg.n_topics
    x = torch.as_tensor(x, dtype=torch.float32)
    d, v = x.shape
    lam0 = _initial_lambda(gen, k, v, lam0)
    rows = x.tensor_split(env.dp_size, dim=0)
    widths = [len(c) for c in torch.arange(v).tensor_split(env.tp_size)]
    grid = env.devices
    xs = [[blk.to(grid[r][m]).contiguous() for m, blk in
           enumerate(rows[r].split(widths, dim=-1))]
          for r in range(env.dp_size)]
    lam = [[blk.to(grid[r][m]).contiguous() for m, blk in
            enumerate(lam0.split(widths, dim=-1))]
           for r in range(env.dp_size)]
    for _ in range(iters):
        sstats = []
        for r in range(env.dp_size):
            row = all_reduce([l.sum(-1, keepdim=True) for l in lam[r]])
            ee_beta = [torch.exp(torch.special.digamma(l)
                                 - torch.special.digamma(s))
                       for l, s in zip(lam[r], row)]
            gamma = [torch.ones((rows[r].shape[0], k), dtype=torch.float32,
                                device=grid[r][m])
                     for m in range(env.tp_size)]
            for _ in range(cfg.e_step_iters):
                ee_theta = [_exp_dirichlet_expectation(g) for g in gamma]
                dots = all_reduce([
                    (xl / (et @ eb + 1e-30)) @ eb.T
                    for xl, et, eb in zip(xs[r], ee_theta, ee_beta)])
                gamma = [cfg.alpha + et * dot
                         for et, dot in zip(ee_theta, dots)]
            ee_theta = [_exp_dirichlet_expectation(g) for g in gamma]
            sstats.append([(et.T @ (xl / (et @ eb + 1e-30))) * eb
                           for xl, et, eb in zip(xs[r], ee_theta, ee_beta)])
        for m in range(env.tp_size):
            merged = all_reduce([sstats[r][m] for r in range(env.dp_size)])
            for r in range(env.dp_size):
                lam[r][m] = cfg.eta + merged[r]
    return torch.cat([l.to(env.first) for l in lam[0]], dim=-1)
