"""Public wrapper of the sLSTM scan kernel (``csrc/slstm_scan.cu``).

Source note.  ``slstm_scan`` replaces the Pallas kernel
``slstm_scan_pallas`` (``src/repro/kernels/slstm_scan/slstm_scan.py:82``)
and, on the model path, the ``lax.scan`` ``_slstm_local_scan``
(``src/repro/models/recurrent.py:177``) that the JAX model runs.  It is
bound by latency: S dependent steps, each needing all of h_{t-1}.  Each
head's units are split over P co-resident CTAs (a cooperative launch,
P = ceil(hd / units_per_cta(hd)), 32 at hd = 512), each holding its
units' four gate columns of R in shared memory for the whole call; the P
CTAs of a head exchange h_t through a double buffer in device memory and
wait for each other every step.  One launch runs the whole sequence and returns the
final (c, n, h, m) from its single pass (the JAX model runs the scan a
second time for it).  xpre is read through its strides in the model's
batch-major (B, S, 4, H, hd) layout; a time-major (S, B, 4, H, hd) array
is taken as its ``transpose(0, 1)`` view, with no copy.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to the kernel or raises.  ``slstm_scan_launches`` counts
kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.slstm_scan.ref import State, slstm_scan_ref

DTYPES = (torch.float32, torch.bfloat16)

slstm_scan_launches = 0


def units_per_cta(hd: int) -> int:
    """Hidden units per CTA: 16, or the next power of two >= hd when hd
    is smaller (one CTA per head)."""
    u = 1
    while u < min(hd, 16):
        u *= 2
    return u


def slstm_scan(xpre: torch.Tensor, r_mat: torch.Tensor, c0: torch.Tensor,
               n0: torch.Tensor, h0: torch.Tensor, m0: torch.Tensor
               ) -> Tuple[torch.Tensor, State]:
    """xpre: (B, S, 4, H, hd) gate pre-activations (z, i, f, o), float32
    or bfloat16; r_mat: (H, hd, 4 hd), float32 or bfloat16; state (c, n,
    h, m): (B, H, hd) float32.  Returns (h_out (B, S, H, hd) in xpre's
    dtype, the final (c, n, h, m) in float32), computed in float32.

    On the card, H * ceil(hd / units_per_cta(hd)) CTAs must be resident
    at once; a grid that cannot be is refused with ``KernelError``."""
    if xpre.dim() != 5 or xpre.shape[2] != 4:
        raise ValueError(f"xpre must be (B, S, 4, H, hd), got "
                         f"{tuple(xpre.shape)}")
    b, s, _, h, hd = xpre.shape
    if s < 1:
        raise ValueError("xpre holds no step (S = 0)")
    if tuple(r_mat.shape) != (h, hd, 4 * hd):
        raise ValueError(f"r_mat must be {(h, hd, 4 * hd)}, got "
                         f"{tuple(r_mat.shape)}")
    state = (c0, n0, h0, m0)
    for name, t in zip("cnhm", state):
        if tuple(t.shape) != (b, h, hd):
            raise ValueError(f"state {name} must be {(b, h, hd)}, got "
                             f"{tuple(t.shape)}")
    dev = common.same_device(xpre=xpre, r_mat=r_mat, c0=c0, n0=n0, h0=h0,
                             m0=m0)
    if dev.type == "cpu":
        return slstm_scan_ref(xpre, r_mat, c0, n0, h0, m0)
    common.require_cuda("xpre", xpre, dev, DTYPES, contiguous=False)
    common.require_cuda("r_mat", r_mat, dev, DTYPES)
    for name, t in zip("cnhm", state):
        common.require_cuda(f"state {name}", t, dev)
    out = torch.empty((b, s, h, hd), dtype=xpre.dtype, device=dev)
    c1, n1, h1, m1 = (torch.empty((b, h, hd), dtype=torch.float32,
                                  device=dev) for _ in range(4))
    hbuf = torch.empty((2, b, h, hd), dtype=torch.float32, device=dev)
    arrive = torch.zeros(h, dtype=torch.int32, device=dev)
    code = {torch.float32: 0, torch.bfloat16: 1}
    lib = common.load_library()
    with torch.cuda.device(dev):
        status = lib.mlego_slstm_scan(
            xpre.data_ptr(), r_mat.data_ptr(), c0.data_ptr(), n0.data_ptr(),
            h0.data_ptr(), m0.data_ptr(), out.data_ptr(), c1.data_ptr(),
            n1.data_ptr(), h1.data_ptr(), m1.data_ptr(), hbuf.data_ptr(),
            arrive.data_ptr(), code[xpre.dtype], code[r_mat.dtype], b, s, h,
            hd, units_per_cta(hd), *xpre.stride()[:4],
            common.stream_of(xpre))
    common.check_launch(status, "slstm_scan")
    common.count_launch(globals(), "slstm_scan_launches")
    return out, (c1, n1, h1, m1)
