"""Oracle: exact sequential RWKV-6 recurrence (``repro/kernels/rwkv6/
ref.py``, in torch)."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, logw, u):
    """r,k,v,logw: (B, H, S, dh); u: (H, dh). Exact step-by-step recurrence:
        o_t = r_t (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    """
    B, H, S, dh = r.shape
    r32, k32, v32 = (a.float() for a in (r, k, v))
    w = torch.exp(logw.float())
    u32 = u.float()

    S_ = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        rt, kt, vt, wt = r32[:, :, t], k32[:, :, t], v32[:, :, t], w[:, :, t]
        kv = torch.einsum("bhd,bhe->bhde", kt, vt)
        outs.append(torch.einsum("bhd,bhde->bhe", rt,
                                 S_ + u32[None, :, :, None] * kv))
        S_ = wt[..., None] * S_ + kv
    return torch.stack(outs, dim=2)          # (B, H, S, dh)
