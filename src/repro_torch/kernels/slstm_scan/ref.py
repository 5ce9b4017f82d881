"""Plain PyTorch version of the sLSTM scan: the math of
``slstm_scan_ref`` (``src/repro/kernels/slstm_scan/ref.py``) in the
model's batch-major layout, as ``_slstm_local_scan``
(``src/repro/models/recurrent.py:177``) takes it.  The CPU path and the
tests use it; nothing on the CUDA path calls it."""
from __future__ import annotations

from typing import Tuple

import torch

M_INIT = -1e30       # the stabiliser's initial m (finite: exp(-1e30) = 0)

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def logsig(x: torch.Tensor) -> torch.Tensor:
    """log(sigmoid(x)) = -softplus(-x), in the form of JAX's ``softplus``
    (``logaddexp(-x, 0)``)."""
    return torch.minimum(x, torch.zeros_like(x)) \
        - torch.log1p(torch.exp(-x.abs()))


def zero_state(b: int, h: int, hd: int, device) -> State:
    """(c, n, h, m) of a fresh sequence: zeros and m = -1e30, float32."""
    z = torch.zeros((b, h, hd), dtype=torch.float32, device=device)
    return z, z.clone(), z.clone(), torch.full_like(z, M_INIT)


def slstm_scan_ref(xpre: torch.Tensor, r_mat: torch.Tensor,
                   c0: torch.Tensor, n0: torch.Tensor, h0: torch.Tensor,
                   m0: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """xpre: (B, S, 4, H, hd) gate pre-activations (z, i, f, o), any float
    dtype; r_mat: (H, hd, 4 hd), the block-diagonal recurrent matrix (f32
    or bf16-valued); state (c, n, h, m): (B, H, hd) float32; S >= 1.

    Computes in float32 and returns (h_out (B, S, H, hd) in xpre's dtype,
    the final (c, n, h, m) in float32)."""
    b, s, _, h, hd = xpre.shape
    r = r_mat.float()
    c, nrm, hprev, m = (t.float() for t in (c0, n0, h0, m0))
    out = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", hprev, r).reshape(b, h, 4, hd)
        tot = xpre[:, t].float() + rec.transpose(1, 2)      # (B, 4, H, hd)
        z = torch.tanh(tot[:, 0])
        logi = tot[:, 1]
        logf = logsig(tot[:, 2])
        o = torch.sigmoid(tot[:, 3])
        m_new = torch.maximum(logf + m, logi)
        i_s = torch.exp(logi - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * z
        nrm = f_s * nrm + i_s
        hprev = o * c / torch.clamp(nrm, min=1e-6)
        m = m_new
        out.append(hprev)
    return torch.stack(out, dim=1).to(xpre.dtype), (c, nrm, hprev, m)
