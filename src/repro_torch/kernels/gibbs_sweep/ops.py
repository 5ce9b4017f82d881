"""Public wrappers of the Gibbs sweep kernels (``csrc/gibbs_sweep.cu``).

Source note.  ``gibbs_sweep`` replaces the Pallas kernel
``gibbs_sweep_pallas`` (``src/repro/kernels/gibbs_sweep/gibbs_sweep.py:88``)
and takes the argument layout of ``repro.kernels.gibbs_sweep.ops.
gibbs_sweep``.  ``cgs_sweep_exact`` is the counterpart of the jitted
``lax.scan`` ``_cgs_sweeps`` (``src/repro/core/gibbs.py:34``) — not a
Pallas kernel, but on the card its plain version would be tens of
thousands of tiny launches per sweep, so it has a kernel too.

Both are bound by latency, not by bytes or flops: every token's draw
depends on the previous one through the counts, so a sweep is a chain of
dependent steps — T_max per doc block for the blocked sweep, every token
of the partition for the exact one — each one L2 round trip for the
token's K-wide row plus a warp scan.  The design gives a chain one warp
with the topics across its lanes, keeps what a lane reads in the lane
that writes it (so the chain needs no barrier), and reads each token's
counts as one contiguous row of a (V, K) transpose, which each wrapper
builds itself.  The blocked sweep runs its doc blocks in parallel, one
warp each, with the block's n_kd in shared memory; the exact sweep is
one warp in one CTA, with n_kd and n_kv^T in device memory (L2).  No
padding of K, V, T or BD: the kernels mask the ragged edge themselves.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to the kernel or raises.  ``gibbs_sweep_launches`` and
``cgs_sweep_exact_launches`` count kernel launches (one per sweep).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.gibbs_sweep.ref import (
    cgs_sweep_exact_ref,
    gibbs_sweep_ref,
)

MAX_TOPICS = 1024              # 32 lanes x 32 topics per lane
MAX_SHARED_BYTES = 232448      # shared memory one block may use on sm_90

gibbs_sweep_launches = 0
cgs_sweep_exact_launches = 0


def gibbs_sweep(words: torch.Tensor, ldoc: torch.Tensor, mask: torch.Tensor,
                u: torch.Tensor, z: torch.Tensor, nkd: torch.Tensor,
                prior: torch.Tensor, prior_k: torch.Tensor, alpha: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One doc-blocked CGS sweep.

    words/ldoc/z (B, T) int32, mask/u (B, T) float32 (mask 0 or 1),
    nkd (B, BD, K), prior (K, V) snapshot + global + β, prior_k (K,) its
    row sums (with Vβ).  Returns (z', nkd', nkv (K, V)) with nkv the new
    assignments' counts summed over blocks.
    """
    if words.dim() != 2 or nkd.dim() != 3 or prior.dim() != 2:
        raise ValueError("words must be (B, T), nkd (B, BD, K), prior (K, V)")
    b, t = words.shape
    _, bd, k = nkd.shape
    v = prior.shape[1]
    for name, x in (("ldoc", ldoc), ("mask", mask), ("u", u), ("z", z)):
        if x.shape != (b, t):
            raise ValueError(f"{name} must be ({b}, {t}), got "
                             f"{tuple(x.shape)}")
    if nkd.shape[0] != b or prior.shape[0] != k or prior_k.shape != (k,):
        raise ValueError(f"nkd {tuple(nkd.shape)}, prior "
                         f"{tuple(prior.shape)} and prior_k "
                         f"{tuple(prior_k.shape)} disagree on B or K")
    dev = common.same_device(words=words, ldoc=ldoc, mask=mask, u=u, z=z, nkd=nkd,
                       prior=prior, prior_k=prior_k)
    if dev.type == "cpu":
        return gibbs_sweep_ref(words, ldoc, mask, u, z, nkd, prior, prior_k,
                               alpha)
    for name, x in (("words", words), ("ldoc", ldoc), ("z", z)):
        common.require_cuda(name, x, dev, torch.int32)
    for name, x in (("mask", mask), ("u", u), ("nkd", nkd),
                    ("prior", prior), ("prior_k", prior_k)):
        common.require_cuda(name, x, dev)
    if not 1 <= k <= MAX_TOPICS or bd * k * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"gibbs_sweep kernel takes 1 <= K <= {MAX_TOPICS} and a block's "
            f"n_kd (BD x K x 4 bytes) within {MAX_SHARED_BYTES} bytes of "
            f"shared memory; got K={k}, BD={bd} ({bd * k * 4} bytes)")
    prior_t = prior.t().contiguous()
    z_out = torch.empty_like(z)
    nkd_out = torch.empty_like(nkd)
    nkv = torch.zeros((k, v), dtype=torch.float32, device=dev)
    lib = common.load_library()
    status = lib.mlego_gibbs_sweep_blocked(
        words.data_ptr(), ldoc.data_ptr(), mask.data_ptr(), u.data_ptr(),
        z.data_ptr(), nkd.data_ptr(), prior_t.data_ptr(), prior_k.data_ptr(),
        z_out.data_ptr(), nkd_out.data_ptr(), nkv.data_ptr(), b, t, bd, k, v,
        float(alpha), common.stream_of(words))
    common.check_launch(status, "gibbs_sweep")
    common.count_launch(globals(), "gibbs_sweep_launches")
    return z_out, nkd_out, nkv


def cgs_sweep_exact(tokens: torch.Tensor, doc_ids: torch.Tensor,
                    u: torch.Tensor, z: torch.Tensor, nkd: torch.Tensor,
                    nkv: torch.Tensor, nk: torch.Tensor,
                    global_nkv: torch.Tensor, gk: torch.Tensor,
                    alpha: float, beta: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """One exact CGS sweep over a partition's token stream.

    tokens/doc_ids/z (T,) int32, u (T,) float32, nkd (D, K), nkv (K, V)
    local counts, nk (K,) their row sums, global_nkv (K, V) the DSGS prior
    and gk (K,) its row sums.  Returns (z', nkd', nkv', nk').
    """
    if tokens.dim() != 1 or nkd.dim() != 2 or nkv.dim() != 2:
        raise ValueError("tokens must be (T,), nkd (D, K), nkv (K, V)")
    t = tokens.shape[0]
    k, v = nkv.shape
    for name, x in (("doc_ids", doc_ids), ("u", u), ("z", z)):
        if x.shape != (t,):
            raise ValueError(f"{name} must be ({t},), got {tuple(x.shape)}")
    if nkd.shape[1] != k or nk.shape != (k,) or gk.shape != (k,) \
            or global_nkv.shape != (k, v):
        raise ValueError(f"nkd {tuple(nkd.shape)}, nk {tuple(nk.shape)}, "
                         f"global_nkv {tuple(global_nkv.shape)} and gk "
                         f"{tuple(gk.shape)} disagree with nkv "
                         f"{tuple(nkv.shape)}")
    dev = common.same_device(tokens=tokens, doc_ids=doc_ids, u=u, z=z, nkd=nkd,
                       nkv=nkv, nk=nk, global_nkv=global_nkv, gk=gk)
    if dev.type == "cpu":
        return cgs_sweep_exact_ref(tokens, doc_ids, u, z, nkd, nkv, nk,
                                   global_nkv, gk, alpha, beta)
    for name, x in (("tokens", tokens), ("doc_ids", doc_ids), ("z", z)):
        common.require_cuda(name, x, dev, torch.int32)
    for name, x in (("u", u), ("nkd", nkd), ("nkv", nkv), ("nk", nk),
                    ("global_nkv", global_nkv), ("gk", gk)):
        common.require_cuda(name, x, dev)
    if not 1 <= k <= MAX_TOPICS or t < 1:
        raise ValueError(f"cgs_sweep_exact kernel takes 1 <= K <= "
                         f"{MAX_TOPICS} and T >= 1; got K={k}, T={t}")
    # the kernel updates these in place
    z_out, nkd_out, nk_out = z.clone(), nkd.clone(), nk.clone()
    nkv_t = nkv.t().contiguous()
    g_t = global_nkv.t().contiguous()
    # V·β rounded in float32, as JAX forms it from the traced β
    vbeta = float(np.float32(v) * np.float32(beta))
    lib = common.load_library()
    status = lib.mlego_gibbs_sweep_exact(
        tokens.data_ptr(), doc_ids.data_ptr(), u.data_ptr(), z_out.data_ptr(),
        nkd_out.data_ptr(), nkv_t.data_ptr(), nk_out.data_ptr(),
        g_t.data_ptr(), gk.data_ptr(), t, k, float(alpha), float(beta),
        vbeta, common.stream_of(tokens))
    common.check_launch(status, "cgs_sweep_exact")
    common.count_launch(globals(), "cgs_sweep_exact_launches")
    return z_out, nkd_out, nkv_t.t().contiguous(), nk_out
