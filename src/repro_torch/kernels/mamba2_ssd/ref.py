"""Oracle: exact sequential SSD recurrence (``repro/kernels/mamba2_ssd/
ref.py``, in torch)."""
from __future__ import annotations

import torch


def ssd_ref(x, lw, Bm, Cm):
    """x: (B,H,S,dh) dt-weighted; lw: (B,H,S); Bm,Cm: (B,S,N).
        S_t = a_t S_{t-1} + x_t B_t^T ;  y_t = S_t C_t   (a_t = exp(lw_t))
    """
    B, H, S, dh = x.shape
    N = Bm.shape[-1]
    x32 = x.float()
    a = torch.exp(lw.float())
    B32, C32 = Bm.float(), Cm.float()

    S_ = torch.zeros((B, H, dh, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        upd = torch.einsum("bhd,bn->bhdn", x32[:, :, t], B32[:, t])
        S_ = a[:, :, t][..., None, None] * S_ + upd
        ys.append(torch.einsum("bhdn,bn->bhd", S_, C32[:, t]))
    return torch.stack(ys, dim=2)            # (B, H, S, dh)
