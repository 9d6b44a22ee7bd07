"""RWKV-6 (Finch) of ``repro/models/rwkv6.py``, in PyTorch: attention-free
time-mix with data-dependent decay.

Recurrence (per head, state S in R^{dh x dh}):
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
with per-channel decay w_t = exp(-exp(w0 + lora(x_w))) data-dependent per
token. Prefill runs the chunked form, which on a CUDA tensor is the port's
kernel K7 (``kernels/rwkv6``) and on a CPU tensor its plain version; decode
is the exact single-step recurrence in plain torch, as in the reference. K7
has no backward, so training (``train=True``) runs ``wkv_chunked_train``,
the reference's XLA chunked form as torch ops under autograd.
Parameters keep the reference's names and ``(L, ...)``-stacked layout.

On a mesh the training step splits the heads over 'model', as the
reference's constraint on r, k, v and logw (``rwkv6.py:73``) does
(``rwkv_block`` given the 'model' group): each rank gathers the sequence,
token-shifts it whole, projects its heads' columns (``wr``, ``wk``, ``wv``, ``wg``, the
decay LoRA's ``wb``), scans and group-norms them and leaves through the
row-parallel ``wo``; the channel mix is column-parallel in ``wck`` and
row-parallel in ``wcv``, its receptance taken on the rank's sequence
slice with the whole ``wcr``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import resolve_init_device
from ..kernels.rwkv6 import wkv6_op
from .layers import normal_init, rmsnorm, rmsnorm_train, upcast


def init_rwkv_layer(gen: torch.Generator, cfg, n_layers: int,
                    dtype=torch.float32, device=None):
    D, Fd = cfg.d_model, cfg.d_ff
    H, dh = cfg.n_heads, cfg.rwkv.head_size
    r = cfg.rwkv.decay_lora
    L = (n_layers,)
    kw = dict(dtype=dtype, device=resolve_init_device(device))
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln1": torch.ones(L + (D,), **kw),
        "ln2": torch.ones(L + (D,), **kw),
        # static token-shift lerp coefficients for r,k,v,w,g
        "mu": 0.5 * torch.ones(L + (5, D), **kw),
        "wr": normal_init(gen, L + (D, H * dh), **kw),
        "wk": normal_init(gen, L + (D, H * dh), **kw),
        "wv": normal_init(gen, L + (D, H * dh), **kw),
        "wg": normal_init(gen, L + (D, H * dh), **kw),
        "wo": normal_init(gen, L + (H * dh, D), out_scale, **kw),
        "w0": -6.0 * torch.ones(L + (H, dh), **kw),       # decay base
        "wa": normal_init(gen, L + (D, r), 0.01, **kw),    # decay lora in
        "wb": normal_init(gen, L + (r, H * dh), 0.01, **kw),
        "u": normal_init(gen, L + (H, dh), 0.5, **kw),     # bonus
        "gn": torch.ones(L + (H * dh,), **kw),             # group-norm scale
        # channel-mix
        "mu_c": 0.5 * torch.ones(L + (2, D), **kw),
        "wck": normal_init(gen, L + (D, Fd), **kw),
        "wcv": normal_init(gen, L + (Fd, D), out_scale, **kw),
        "wcr": normal_init(gen, L + (D, D), **kw),
    }


def _shift(x, prev):
    """Token shift: x_{t-1}, with `prev` (B,1,D) filling position 0."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _projections(x, xprev, p, H: int, dh: int):
    # the lerps run in x's dtype in the reference's order of operations
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = [x + (xprev - x) * mu[i] for i in range(5)]
    B, S, _ = x.shape
    r = (xr @ p["wr"].to(x.dtype)).reshape(B, S, H, dh)
    k = (xk @ p["wk"].to(x.dtype)).reshape(B, S, H, dh)
    v = (xv @ p["wv"].to(x.dtype)).reshape(B, S, H, dh)
    g = xg @ p["wg"].to(x.dtype)
    lora = (torch.tanh(xw @ p["wa"].to(x.dtype)).reshape(B * S, -1)
            @ p["wb"].to(x.dtype)).reshape(B, S, H, dh)
    logw = -torch.exp(upcast(p["w0"]) + upcast(lora))
    logw = torch.clamp(logw, -20.0, -1e-6)               # (B,S,H,dh), < 0
    return r, k, v, g, logw


def wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Chunked RWKV6 core through K7. r,k,v,logw: (B,S,H,dh); u: (H,dh);
    state: (B,H,dh,dh). Returns out (B,S,H,dh) f32, new state."""
    return wkv6_op(r, k, v, logw, u, chunk=chunk, state=state)


def wkv_chunked_train(r, k, v, logw, u, state, chunk: int):
    """The reference's ``wkv_chunked`` (``repro/models/rwkv6.py:78``) for
    training, differentiable: r,k,v,logw (B,S,H,dh); u (H,dh); state
    (B,H,dh,dh). A ragged last chunk is padded with identity steps (k = v =
    0, logw = 0); the chunks run in a Python loop where the reference
    scans. Returns out (B,S,H,dh) f32, new state.

    One difference: the pairwise decay exp(cumex_t - cum_s) is taken of
    min(cumex_t - cum_s, 0). For s < t the exponent is a sum of log-decays,
    never positive, so nothing there changes; for s >= t, which the
    triangle masks out, the reference takes exp of a positive sum, which
    overflows once the decays are strong (lw -5 over a 32-step chunk), and
    its gradient is then NaN where its output is finite (ROADMAP R8)."""
    B, S, H, dh = r.shape
    Sorig = S
    if S % chunk:
        pad = chunk - S % chunk
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
        S += pad
    uf = upcast(u)            # f32 as the reference (f64 for f64 inputs)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)
    S0 = state.to(torch.promote_types(uf.dtype, upcast(r).dtype))
    outs = []
    for c0 in range(0, S, chunk):
        rb, kb, vb, lwb = (upcast(a[:, c0:c0 + chunk].transpose(1, 2))
                           for a in (r, k, v, logw))      # (B,H,T,dh)
        cum = torch.cumsum(lwb, dim=2)                   # inclusive
        cumex = cum - lwb                                # exclusive
        # scores[t,s] = sum_d r[t,d] k[s,d] exp(cumex[t,d] - cum[s,d]), s<t
        decay = torch.exp(torch.clamp(
            cumex[:, :, :, None, :] - cum[:, :, None, :, :], max=0.0))
        scores = torch.einsum("bhtd,bhsd,bhtsd->bhts", rb, kb, decay)
        scores = torch.where(tri, scores, 0.0)
        diag = torch.einsum("hd,bhtd,bhtd->bht", uf, rb, kb)
        out = torch.einsum("bhts,bhsd->bhtd", scores, vb)
        out = out + diag[..., None] * vb
        # inter-chunk: r_t * P_{t-1} @ S0
        out = out + torch.einsum("bhtd,bhde->bhte", rb * torch.exp(cumex), S0)
        # S' = diag(P_T) S0 + sum_s diag(exp(cum_T - cum_s)) k_s^T v_s
        pT = torch.exp(cum[:, :, -1])                    # (B,H,dh)
        ksc = kb * torch.exp(cum[:, :, -1:, :] - cum)
        S0 = pT[..., None] * S0 + torch.einsum("bhtd,bhte->bhde", ksc, vb)
        outs.append(out)
    out = torch.cat(outs, dim=2).transpose(1, 2)
    return out[:, :Sorig], S0


def wkv_step(r, k, v, logw, u, state):
    """Exact single-token recurrence. r,k,v,logw: (B,1,H,dh); state
    (B,H,dh,dh)."""
    r32, k32, v32 = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    kv = torch.einsum("bhd,bhe->bhde", k32, v32)
    out = torch.einsum("bhd,bhde->bhe", r32,
                       state + u.float()[None, :, :, None] * kv)
    state = torch.exp(logw[:, 0].float())[..., None] * state + kv
    return out[:, None], state


def time_mix(x, p, cfg, state, train: bool = False, n: Optional[int] = None,
             grp=None):
    """state: dict(shift (B,1,D), wkv (B,H,dh,dh)), or None for a zero
    state. Returns (y, new_state). ``train``: the differentiable scan in
    place of K7.

    With ``grp`` (tensor-parallel) ``x`` is this rank's sequence
    slice of a sequence ``n`` long: the mix runs on the gathered sequence,
    token-shifted whole, its heads split over the group where
    :func:`rwkv_heads_split` (the rank's columns of ``wr``, ``wk``,
    ``wv``, ``wg`` and the decay LoRA's ``wb``; ``wo`` row-parallel), else
    whole on every rank, and ``y`` is this rank's slice. A split state's
    ``wkv`` holds the rank's heads (as ``init_rwkv_state(tp=)`` and the
    cache place it). With ``n`` None (a decode step) ``x`` is whole on
    every rank and ``wo``'s partial sums are all-reduced."""
    from ..dist.sharding import gather_seq, leave_block, seq_slice
    if grp is not None and not rwkv_heads_split(cfg, grp.size):
        y, st = time_mix(gather_seq(x, n, grp), p, cfg, state, train)
        return seq_slice(y, None if n is None else grp), st
    x = gather_seq(x, n, grp)
    tp, rank = (1, 0) if grp is None else (grp.size, grp.rank)
    H, dh = cfg.n_heads // tp, cfg.rwkv.head_size
    B, S, D = x.shape
    hs = slice(rank * H, (rank + 1) * H)
    if state is None:
        shift = x.new_zeros((B, 1, D))
        wkv0 = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                           device=x.device)
    else:
        shift, wkv0 = state["shift"], state["wkv"]
    xprev = _shift(x, shift) if S > 1 else shift
    r, k, v, g, logw = _projections(x, xprev, {**p, "w0": p["w0"][hs]}, H,
                                    dh)
    if S == 1:
        out, wkv = wkv_step(r, k, v, logw, p["u"][hs], wkv0)
    else:
        scan = wkv_chunked_train if train else wkv_chunked
        out, wkv = scan(r, k, v, logw, p["u"][hs], wkv0, cfg.rwkv.chunk)
    out = out.reshape(B, S, H, dh).to(x.dtype)
    # per-head group norm, as the reference writes it (not rmsnorm: no
    # scale, eps 1e-5 inside an f32 rsqrt, then cast to x's dtype)
    out = out * torch.rsqrt(torch.mean(torch.square(upcast(out)), -1,
                                       keepdim=True) + 1e-5).to(x.dtype)
    gn = p["gn"][hs.start * dh:hs.stop * dh]
    out = out.reshape(B, S, H * dh) * gn.to(x.dtype)
    out = out * F.silu(g)
    y = leave_block(out @ p["wo"].to(x.dtype), n, grp)
    return y, {"shift": x[:, -1:].clone(), "wkv": wkv}


def channel_mix(x, p, cfg, state_shift, n: Optional[int] = None, grp=None):
    """The channel mix; ``state_shift`` (B,1,D), or None for zeros.
    Returns (y, the new shift). With ``grp`` (as :func:`time_mix`) ``wck``
    column-parallel and ``wcv`` row-parallel where :func:`channel_split`,
    the receptance taken on this rank's slice with the whole ``wcr``, else
    whole on every rank; ``y`` is this rank's slice."""
    from ..dist.sharding import gather_seq, leave_block, seq_slice
    sgrp = None if n is None else grp       # decode: the residual whole
    if grp is not None and not channel_split(cfg, grp.size):
        y, st = channel_mix(gather_seq(x, n, grp), p, cfg, state_shift)
        return seq_slice(y, sgrp), st
    x = gather_seq(x, n, grp)
    if state_shift is None:
        state_shift = torch.zeros_like(x[:, :1])
    xprev = _shift(x, state_shift) if x.shape[1] > 1 else state_shift
    mu = p["mu_c"].to(x.dtype)
    xk = x + (xprev - x) * mu[0]
    xr = seq_slice(x + (xprev - x) * mu[1], sgrp)
    kk = torch.square(torch.relu(xk @ p["wck"].to(x.dtype)))
    rr = torch.sigmoid(xr @ p["wcr"].to(x.dtype))
    return rr * leave_block(kk @ p["wcv"].to(x.dtype), n, grp), \
        x[:, -1:].clone()


def rwkv_block(x, p, cfg, state, train: bool = False, n: Optional[int] = None,
               grp=None):
    """One RWKV layer. state: {shift, wkv, cshift}, or None for a zero
    state. ``train``: the differentiable ops in place of K4 and K7;
    ``n`` and ``grp`` as for :func:`time_mix`."""
    norm = rmsnorm_train if train else rmsnorm
    st = state or {}
    tm = None if state is None else {"shift": st["shift"], "wkv": st["wkv"]}
    h, tm_state = time_mix(norm(x, p["ln1"], cfg.norm_eps), p, cfg, tm,
                           train, n, grp)
    x = x + h
    h, cshift = channel_mix(norm(x, p["ln2"], cfg.norm_eps), p, cfg,
                            st.get("cshift"), n, grp)
    x = x + h
    return x, {"shift": tm_state["shift"], "wkv": tm_state["wkv"],
               "cshift": cshift}


def init_rwkv_state(cfg, batch: int, dtype=torch.float32, device=None,
                    tp: int = 1):
    """Zero states; ``tp``: the 'model' ranks the heads split over
    (``wkv`` then holds a rank's heads)."""
    H, dh, D = cfg.n_heads // tp, cfg.rwkv.head_size, cfg.d_model
    L = cfg.n_layers
    dev = resolve_init_device(device)
    return {
        "shift": torch.zeros((L, batch, 1, D), dtype=dtype, device=dev),
        "wkv": torch.zeros((L, batch, H, dh, dh), dtype=torch.float32,
                           device=dev),
        "cshift": torch.zeros((L, batch, 1, D), dtype=dtype, device=dev),
    }


def rwkv_heads_split(cfg, tp: int) -> bool:
    """Whether the time mix splits its heads over a 'model' of ``tp``
    ranks; else every rank runs it whole on the whole sequence."""
    return cfg.n_heads % tp == 0


def channel_split(cfg, tp: int) -> bool:
    """Whether the channel mix splits ``d_ff`` over ``tp`` ranks."""
    return cfg.d_ff % tp == 0
