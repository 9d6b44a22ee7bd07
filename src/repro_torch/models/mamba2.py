"""The Mamba-2 (SSD) layer of ``repro/models/mamba2.py``, in PyTorch.

State-space dual form: per head h with state S in R^{dh x N}:
    S_t = a_t S_{t-1} + (dt_t x_t) B_t^T        (a_t = exp(dt_t * A_h), A_h < 0)
    y_t = C_t^T S_t^T + D_h x_t
Prefill runs the chunked SSD scan, which on a CUDA tensor is the port's
kernel K6 (``kernels/mamba2_ssd``) and on a CPU tensor its plain version;
decode is the exact recurrence in plain torch, as in the reference. K6 has
no backward, so training (``train=True``) runs ``ssd_chunked_train``, the
reference's XLA chunked scan as torch ops under autograd.
Parameters keep the reference's names and ``(L, ...)``-stacked layout.

On a mesh the training step splits the SSD heads over 'model', as the
reference's constraint on ``xh`` and ``dt`` (``mamba2.py:136-137``) does
(``mamba_block`` given the 'model' group): each rank gathers the sequence, projects its
heads' columns of z, x and dt and the shared B and C from the whole
``in_proj``, convolves its channels, scans its heads, takes the gated
norm's moment over every rank's share of ``d_inner`` and leaves through
the row-parallel ``out_proj``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import obs
from ..device import resolve_init_device
from ..kernels import mamba2_glue as glue
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
    scans them with K6 (the span ``mamba2.scan``: K6 alone). Returns y
    (B,S,H,dh) f32, new state."""
    A = -torch.exp(a_log.float())                       # (H,) negative
    lw = dt.float() * A                                 # (B,S,H)
    xs = xh.float() * dt.float()[..., None]             # (B,S,H,dh)
    Bf, Cf = Bm.float(), Cm.float()
    with obs.span("mamba2.scan", xs):
        return ssd_chunked_op(xs, lw, Bf, Cf, chunk=chunk, state=state)


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


def mamba_block(x, p, cfg, state, train: bool = False,
                n: Optional[int] = None, grp=None):
    """One Mamba2 layer. state: {ssm (B,H,dh,N) fp32, conv (B,K-1,di+2N)},
    or None for a zero state. ``train``: the differentiable ops in place
    of K4 and K6. Returns (x plus the layer's output, the new state).

    With ``grp`` (tensor-parallel) ``x`` is this rank's sequence slice of
    a sequence ``n`` long, the layer runs on the gathered sequence and
    adds this rank's slice of its output: its SSD heads split over the
    group where :func:`ssd_heads_split` (:func:`_head_share`; the gated
    norm's moment summed over the ranks, ``out_proj`` row-parallel), else
    every rank runs the whole layer. With ``n`` None (a decode step) ``x``
    is whole on every rank and ``out_proj``'s partial sums are
    all-reduced. A split state holds the rank's heads of ``ssm`` (as
    ``init_mamba_state(tp=)`` and the cache place it) and the whole
    ``conv``; serving (not ``train``) returns the conv state whole.

    A bf16 serving prefill on the card with the whole of d_inner
    (:func:`_glue_kernels`) runs the glue between ``in_proj``, K6 and
    ``out_proj`` as two kernels (``kernels/mamba2_glue``), bit for bit
    the torch ops the other paths run.

    Spans (``obs``): ``mamba2.layer`` from the pre-norm to the residual
    add, and in it ``mamba2.in_proj`` and ``mamba2.out_proj``, the two
    GEMMs alone."""
    from ..dist.sharding import gather_seq, seq_slice
    if grp is not None and not ssd_heads_split(cfg, grp.size):
        full, st = mamba_block(gather_seq(x, n, grp), p, cfg, state, train)
        return seq_slice(full, None if n is None else grp), st
    with obs.span("mamba2.layer", x):
        return _mixer(x, p, cfg, state, train, n, grp)


def _mixer(x, p, cfg, state, train: bool, n: Optional[int], grp):
    """:func:`mamba_block` on the rank's share of the SSD heads."""
    from ..dist.sharding import gather_model, gather_seq, leave_block
    s = cfg.ssm
    di = s.expand * cfg.d_model
    tp = 1 if grp is None else grp.size
    H, dh, N = di // s.d_head // tp, s.d_head, s.d_state
    norm = rmsnorm_train if train else rmsnorm
    h = gather_seq(norm(x, p["ln"], cfg.norm_eps), n, grp)
    B, S, _ = h.shape
    p, state = _head_share(p, state, cfg, grp)
    if state is None:
        state = {"ssm": torch.zeros((B, H, dh, N), dtype=torch.float32,
                                    device=x.device), "conv": None}
    with obs.span("mamba2.in_proj", h):
        proj = h @ p["in_proj"].to(x.dtype)
    z, conv_in, dt = torch.split(proj, [di // tp, di // tp + 2 * N, H],
                                 dim=-1)
    if _glue_kernels(h, cfg, train, grp):
        y, ssm, conv_state = _glue_prefill(z, conv_in, dt, p, cfg, state)
    else:
        conv_out, conv_state = _causal_conv(conv_in, p["conv_w"],
                                            p["conv_b"], state["conv"])
        conv_out = F.silu(conv_out)
        xin, Bm, Cm = torch.split(conv_out, [di // tp, N, N], dim=-1)
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
        y = y.reshape(B, S, di // tp).to(x.dtype) * F.silu(z)
        # a group of one holds the whole d_inner: K4 (serving), as alone
        whole = grp is None or (grp.size == 1 and not train)
        y = norm(y, p["norm"], cfg.norm_eps) if whole else \
            _rmsnorm_split(y, p["norm"], cfg.norm_eps, di, grp)
    with obs.span("mamba2.out_proj", y):
        out = y @ p["out_proj"].to(x.dtype)
    out = leave_block(out, n, grp)
    if grp is not None and not train:       # the cache's conv state: whole
        conv_state = torch.cat([gather_model(conv_state[..., :di // tp],
                                             grp),
                                conv_state[..., di // tp:]], -1)
    return x + out, {"ssm": ssm, "conv": conv_state}


def _glue_kernels(h: torch.Tensor, cfg, train: bool, grp) -> bool:
    """Whether the layer's glue runs as ``kernels/mamba2_glue``'s two
    kernels: a bf16 serving prefill (not ``train``, more than one token)
    on the card, with the whole of d_inner on this rank (no group, or one
    of one rank), at widths the kernels take."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return (h.is_cuda and h.dtype == torch.bfloat16 and not train
            and h.shape[1] > 1 and (grp is None or grp.size == 1)
            and glue.takes(di, s.d_state, di // s.d_head, s.d_conv))


def _glue_prefill(z, conv_in, dt, p, cfg, state):
    """The glue of :func:`_mixer` between ``in_proj`` and ``out_proj``
    through the two kernels: (the normed gate, the new SSM state, the new
    conv state). Rounds where the torch ops of the other paths round."""
    xs, lw, Bm, Cm, xh, conv_state = glue.mamba2_conv_in(
        conv_in, dt, state["conv"], p["conv_w"], p["conv_b"], p["dt_bias"],
        p["A_log"], d_state=cfg.ssm.d_state)
    with obs.span("mamba2.scan", xs):
        y, ssm = ssd_chunked_op(xs, lw, Bm, Cm, chunk=cfg.ssm.chunk,
                                state=state["ssm"])
    y = glue.mamba2_gate_norm(y, xh, z, p["D"], p["norm"], cfg.norm_eps)
    return y, ssm, conv_state


def init_mamba_state(cfg, n_layers: int, batch: int, dtype=torch.float32,
                     device=None, tp: int = 1):
    """Zero states; ``tp``: the 'model' ranks the SSD heads split over
    (``ssm`` then holds a rank's heads)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H, dh, N = di // s.d_head // tp, s.d_head, s.d_state
    dev = resolve_init_device(device)
    return {
        "ssm": torch.zeros((n_layers, batch, H, dh, N), dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((n_layers, batch, s.d_conv - 1, di + 2 * N),
                            dtype=dtype, device=dev),
    }


def ssd_heads_split(cfg, tp: int) -> bool:
    """Whether the SSD heads split over a 'model' of ``tp`` ranks; else
    every rank runs the whole layer on the whole sequence."""
    s = cfg.ssm
    return (s.expand * cfg.d_model // s.d_head) % tp == 0


def _spans(x: torch.Tensor, spans) -> torch.Tensor:
    """The (start, width) ``spans`` of ``x``'s last dim, joined."""
    return torch.cat([x.narrow(-1, a, w) for a, w in spans], -1)


def share_weights(p, cfg, grp):
    """This rank's share of a Mamba-2 layer's weights (one layer's or the
    stacked layers'; other leaves pass through) when its SSD heads split
    over ``grp``: the columns of ``in_proj`` for its z, x and dt (B and C
    whole), its channels of the conv and the gated norm, its heads'
    ``dt_bias``, ``A_log`` and ``D``. A group of one's share is the
    whole."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H, N = di // s.d_head, s.d_state
    Hl, dl = H // grp.size, di // grp.size
    d0, h0 = grp.rank * dl, grp.rank * Hl
    chans = ((d0, dl), (di, 2 * N))                 # x, B, C of the conv
    return {**p,
            "in_proj": _spans(p["in_proj"], ((d0, dl), (di + d0, dl),
                                             (2 * di, 2 * N),
                                             (2 * di + 2 * N + h0, Hl))),
            "conv_w": _spans(p["conv_w"], chans),
            "conv_b": _spans(p["conv_b"], chans),
            **{k: p[k].narrow(-1, h0, Hl) for k in ("dt_bias", "A_log", "D")},
            "norm": p["norm"].narrow(-1, d0, dl)}


def _head_share(p, state, cfg, grp):
    """(this rank's share of the layer's weights, of its state) when its
    SSD heads split over ``grp``: :func:`share_weights`, unless ``p`` is
    a share already (a serving step's compute copy holds the shares; its
    gated norm is 1/tp wide), and its channels of the conv state (``ssm``
    holds its heads already; None stays None); all of them when ``grp`` is
    None."""
    if grp is None:
        return p, state
    s = cfg.ssm
    di = s.expand * cfg.d_model
    dl = di // grp.size
    if p["norm"].shape[-1] != dl:
        p = share_weights(p, cfg, grp)
    if state is not None and state["conv"] is not None:
        state = {"ssm": state["ssm"], "conv": _spans(
            state["conv"], ((grp.rank * dl, dl), (di, 2 * s.d_state)))}
    return p, state


def _rmsnorm_split(x, scale, eps: float, d: int, grp):
    """:func:`rmsnorm_train` of a last dim of ``d`` split over the group
    (x and scale this rank's share): the mean of squares summed over it."""
    from ..dist.sharding import reduce_model_shared
    xf = upcast(x)
    var = reduce_model_shared(torch.sum(xf * xf, -1), grp) / d
    r = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return (x * r) * scale.to(x.dtype)
