"""The Mamba-2 (SSD) layer of ``repro/models/mamba2.py``, in PyTorch.

State-space dual form: per head h with state S in R^{dh x N}:
    S_t = a_t S_{t-1} + (dt_t x_t) B_t^T        (a_t = exp(dt_t * A_h), A_h < 0)
    y_t = C_t^T S_t^T + D_h x_t
Prefill runs the chunked SSD scan, which on a CUDA tensor is the port's
kernel K6 (``kernels/mamba2_ssd``) and on a CPU tensor its plain version;
decode is the exact recurrence in plain torch, as in the reference. K6 has
no backward, so training (``train=True``) runs ``ssd_chunked_train``, the
reference's XLA chunked scan as torch ops under autograd.
Parameters keep the reference's names and ``(L, ...)``-stacked layout; the
reference's sharding constraints are dropped: on a mesh the port computes
on the gathered copy of the weights (``train/train_step.py``), so no
activation is sharded.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_init_device
from ..kernels.mamba2_ssd import ssd_chunked_op
from .layers import normal_init, rmsnorm, rmsnorm_train, upcast


def init_mamba_layer(gen: torch.Generator, cfg, n_layers: int,
                     dtype=torch.float32, device=None):
    D = cfg.d_model
    s = cfg.ssm
    di = s.expand * D
    H = di // s.d_head
    N = s.d_state
    L = (n_layers,)
    kw = dict(dtype=dtype, device=resolve_init_device(device))
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))
    return {
        "ln": torch.ones(L + (D,), **kw),
        # fused input projection -> [z(di), x(di), B(N), C(N), dt(H)]
        "in_proj": normal_init(gen, L + (D, 2 * di + 2 * N + H), **kw),
        "conv_w": normal_init(gen, L + (s.d_conv, di + 2 * N), 0.2, **kw),
        "conv_b": torch.zeros(L + (di + 2 * N,), **kw),
        "A_log": a_log[None].repeat(n_layers, 1).to(**kw),
        "D": torch.ones(L + (H,), **kw),
        "dt_bias": torch.zeros(L + (H,), **kw),
        "norm": torch.ones(L + (di,), **kw),
        "out_proj": normal_init(gen, L + (di, D),
                                0.02 / math.sqrt(2 * max(cfg.n_layers, 1)),
                                **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state=None):
    """Depthwise causal conv. x: (B,S,C); w: (K,C); returns (y, new_state
    (B,K-1,C)). Each product and sum rounds to x's dtype, in the
    reference's order. The new state is a copy, so it does not keep the
    padded input alive."""
    K = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], K - 1, x.shape[-1]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)
    S = x.shape[1]
    wx = w.to(x.dtype)
    y = xp[:, 0:S] * wx[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * wx[i]
    return y + b.to(x.dtype), xp[:, -(K - 1):].clone()


def ssd_chunked(xh, dt, a_log, Bm, Cm, state, chunk: int):
    """Chunked SSD. xh: (B,S,H,dh); dt: (B,S,H) (post-softplus); a_log:
    (H,) = A_log; Bm, Cm: (B,S,N); state: (B,H,dh,N) fp32. Forms the
    dt-weighted inputs and log-decays in f32 as the reference does, and
    scans them with K6. Returns y (B,S,H,dh) f32, new state."""
    A = -torch.exp(a_log.float())                       # (H,) negative
    lw = dt.float() * A                                 # (B,S,H)
    xs = xh.float() * dt.float()[..., None]             # (B,S,H,dh)
    return ssd_chunked_op(xs, lw, Bm.float(), Cm.float(), chunk=chunk,
                          state=state)


def _segsum(lw):
    """lw: (..., T). Returns (..., T, T) with out[t, s] = sum over s < tau
    <= t of lw[tau], -inf above the diagonal."""
    T = lw.shape[-1]
    cum = torch.cumsum(lw, dim=-1)
    out = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=lw.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked_train(xh, dt, a_log, Bm, Cm, state, chunk: int):
    """The reference's ``ssd_chunked`` (``repro/models/mamba2.py:62``) for
    training, differentiable: the same shapes as :func:`ssd_chunked`, a
    ragged last chunk padded with identity steps (x = 0, lw = 0), the
    chunks in a Python loop where the reference scans. Returns y (B,S,H,dh)
    f32, new state."""
    B, S, H, dh = xh.shape
    Sorig = S
    if S % chunk:
        pad = chunk - S % chunk
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S += pad
    # f32 as the reference (f64 throughout for f64 inputs)
    A = -torch.exp(upcast(a_log))                       # (H,) negative
    lw = upcast(dt) * A                                 # (B,S,H)
    xs = upcast(xh) * upcast(dt)[..., None]             # dt-weighted input
    Bf, Cf = upcast(Bm), upcast(Cm)
    S0 = state.to(lw.dtype)
    ys = []
    for c0 in range(0, S, chunk):
        xb, lb = xs[:, c0:c0 + chunk], lw[:, c0:c0 + chunk]
        Bb, Cb = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]
        Lmat = torch.exp(_segsum(lb.transpose(1, 2)))   # (B,H,T,T)
        # intra-chunk: y[t] = sum_{s<=t} C_t.B_s exp(seg) x_s
        CB = torch.einsum("btn,bsn->bts", Cb, Bb)
        y = torch.einsum("bts,bhts,bshd->bthd", CB, Lmat, xb)
        # inter-chunk: y[t] += C_t S0 decayed to t
        cum = torch.cumsum(lb, dim=1)                   # (B,T,H)
        y = y + torch.einsum("btn,bhdn,bth->bthd", Cb, S0, torch.exp(cum))
        # S1 = exp(cum_T) S0 + sum_s exp(cum_T - cum_s) x_s B_s^T
        pT = torch.exp(cum[:, -1])                      # (B,H)
        w = torch.exp(cum[:, -1:, :] - cum)             # (B,T,H)
        S0 = pT[..., None, None] * S0 + torch.einsum(
            "bshd,bsn,bsh->bhdn", xb, Bb, w)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :Sorig], S0


def ssd_step(xh, dt, a_log, Bm, Cm, state):
    """Exact single-step. xh: (B,1,H,dh); dt: (B,1,H); Bm,Cm: (B,1,N)."""
    A = -torch.exp(a_log.float())
    a = torch.exp(dt[:, 0].float() * A)                 # (B,H)
    xb = xh[:, 0].float() * dt[:, 0].float()[..., None]
    upd = torch.einsum("bhd,bn->bhdn", xb, Bm[:, 0].float())
    state = a[..., None, None] * state + upd
    y = torch.einsum("bhdn,bn->bhd", state, Cm[:, 0].float())
    return y[:, None], state


def mamba_block(x, p, cfg, state, train: bool = False):
    """One Mamba2 layer. state: {ssm (B,H,dh,N) fp32, conv (B,K-1,di+2N)}.
    ``train``: the differentiable ops in place of K4 and K6."""
    s = cfg.ssm
    D = cfg.d_model
    di = s.expand * D
    H, dh, N = di // s.d_head, s.d_head, s.d_state
    B, S, _ = x.shape
    norm = rmsnorm_train if train else rmsnorm
    h = norm(x, p["ln"], cfg.norm_eps)
    proj = h @ p["in_proj"].to(x.dtype)
    z, conv_in, dt = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                        state["conv"])
    conv_out = F.silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    # torch's softplus returns x itself above 20 and jax.nn.softplus
    # x + log1p(exp(-x)); the difference, under 2.1e-9, is below f32's
    # resolution there (one ulp of 20 is 1.9e-6)
    dt = F.softplus(upcast(dt) + upcast(p["dt_bias"]))
    xh = xin.reshape(B, S, H, dh)
    if S == 1:
        y, ssm = ssd_step(xh, dt, p["A_log"], Bm, Cm, state["ssm"])
    else:
        scan = ssd_chunked_train if train else ssd_chunked
        y, ssm = scan(xh, dt, p["A_log"], Bm, Cm, state["ssm"], s.chunk)
    y = y + upcast(p["D"])[None, None, :, None] * upcast(xh)
    y = y.reshape(B, S, di).to(x.dtype)
    y = norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return x + out, {"ssm": ssm, "conv": conv_state}


def init_mamba_state(cfg, n_layers: int, batch: int, dtype=torch.float32,
                     device=None):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H, dh, N = di // s.d_head, s.d_head, s.d_state
    dev = resolve_init_device(device)
    return {
        "ssm": torch.zeros((n_layers, batch, H, dh, N), dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((n_layers, batch, s.d_conv - 1, di + 2 * N),
                            dtype=dtype, device=dev),
    }
