"""Public wrapper of the fused VB E-step kernel (``csrc/vb_estep.cu``).

Source note.  ``vb_estep`` replaces the Pallas kernel
``vb_estep_pallas`` (``src/repro/kernels/vb_estep/vb_estep.py:76``).
It is bound by operations: each iteration does two (D,K)x(K,V)-sized
products, 4·D·K·V fp32 flops against D·V·4 bytes of x, well above the
card's fp32 ridge point.  The design keeps a doc block's γ and eeθ in
shared memory across all iterations and streams x and eeβ in V tiles,
so each iteration reads x once and eeβ once per doc block (from L2),
and the (BD, K) product is summed in registers.  The TPU kernel added
every doc block into one revisited (K, V) sstats block; on the GPU that
becomes a second launch with one CTA per V tile that loops over all
documents — no atomics and no per-block (K, V) partials (156 × 3.3 MB
at D = 5,000).  Full fp32, no TF32.  K is not padded (the TPU wrapper's
K → 128 padding is harmless there because a common factor of eeθ
cancels, and unnecessary here); a ragged last doc block loads zero rows,
so it adds nothing to sstats.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to the kernel or raises.  ``launches`` counts kernel
launches: two per call (iterations, then sstats).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.vb_estep.ref import vb_estep_ref

MAX_TOPICS = 256        # largest K the kernel's template instances take

launches = 0


def vb_estep(x: torch.Tensor, exp_elog_beta: torch.Tensor,
             gamma0: torch.Tensor, alpha: float, n_iters: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused replacement for ``core.vb.vb_estep``'s inner loop.

    x (D, V), exp_elog_beta (K, V), gamma0 (D, K), all float32 on one
    device -> (gamma (D, K), sstats (K, V)).
    """
    d, v = x.shape
    k = exp_elog_beta.shape[0]
    if exp_elog_beta.shape != (k, v) or gamma0.shape != (d, k):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, exp_elog_beta "
            f"{tuple(exp_elog_beta.shape)}, gamma0 {tuple(gamma0.shape)}")
    if not x.device == exp_elog_beta.device == gamma0.device:
        raise ValueError("x, exp_elog_beta and gamma0 must share a device")
    if x.device.type == "cpu":
        return vb_estep_ref(x, exp_elog_beta, gamma0, alpha, n_iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    for name, t in (("x", x), ("exp_elog_beta", exp_elog_beta),
                    ("gamma0", gamma0)):
        common.require_cuda(name, t, dev)
    if not 1 <= k <= MAX_TOPICS or d < 1 or v < 1 or n_iters < 0:
        raise ValueError(f"vb_estep kernel takes 1 <= K <= {MAX_TOPICS}, "
                         f"D, V >= 1 and n_iters >= 0; got K={k}, D={d}, "
                         f"V={v}, n_iters={n_iters}")
    gamma = torch.empty((d, k), dtype=torch.float32, device=dev)
    ee_theta = torch.empty((d, k), dtype=torch.float32, device=dev)
    sstats = torch.empty((k, v), dtype=torch.float32, device=dev)
    lib = common.load_library()
    stream = common.stream_of(x)
    status = lib.mlego_vb_estep_iters(
        x.data_ptr(), exp_elog_beta.data_ptr(), gamma0.data_ptr(),
        gamma.data_ptr(), ee_theta.data_ptr(), d, k, v, float(alpha),
        int(n_iters), stream)
    common.check_launch(status, "vb_estep (iterations)")
    status = lib.mlego_vb_estep_sstats(
        x.data_ptr(), exp_elog_beta.data_ptr(), ee_theta.data_ptr(),
        sstats.data_ptr(), d, k, v, stream)
    common.check_launch(status, "vb_estep (sstats)")
    common.count_launch(globals(), "launches", 2)
    return gamma, sstats
