"""Plain float32 reference of the port's Zamba2 (arXiv:2411.15242): the
token embedding; Mamba-2 layers (RMSNorm, one input projection to z, x, B,
C and dt, a depthwise causal conv with SiLU, softplus(dt + bias), the SSD
scan in its plain chunked form from a zero state, the skip D x, the SiLU(z)
gate, a gated RMSNorm and the output projection); after every
``shared_attn_every``-th layer the one shared attention + SwiGLU block;
the final RMSNorm and the head. The shared block is the port's, which
departs from the published one (``bench/configs/zamba2-1.2b.json``,
``departures``): it reads the residual alone, with no concatenated
embedding, per-call adapter or output map, and its MLP is SwiGLU.

``precision`` "fp8" rounds every product's operands of the bf16 model to
float8 e4m3 (the control); the scan stays float32, as stated.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import plain


def param_specs(c):
    """The weights' layout (``bench/weights.py`` specs), as the program's
    hybrid stack reads them."""
    s = c["ssm"]
    L, D, V = (c["n_layers"],), c["d_model"], c["vocab_size"]
    di, N = s["expand"] * D, s["d_state"]
    H = di // s["d_head"]
    return {"embed": {"tok": ("normal", (V, D), 0.02)},
            "final_norm": ("ones", (D,)),
            "lm_head": ("normal", (D, V), 0.02),
            "layers": {"mamba": {
                "ln": ("ones", L + (D,)),
                "in_proj": ("normal", L + (D, 2 * di + 2 * N + H), 0.02),
                "conv_w": ("normal", L + (s["d_conv"], di + 2 * N), 0.2),
                "conv_b": ("zeros", L + (di + 2 * N,)),
                "A_log": ("log_linspace", L + (H,), 1.0, 16.0),
                "D": ("ones", L + (H,)),
                "dt_bias": ("zeros", L + (H,)),
                "norm": ("ones", L + (di,)),
                "out_proj": ("normal", L + (di, D),
                             0.02 / math.sqrt(2 * c["n_layers"]))}},
            "shared": {"ln1": ("ones", (D,)),
                       "attn": plain.attn_specs(c, ()),
                       "ln2": ("ones", (D,)),
                       "mlp": plain.mlp_specs(c, ())}}


def ssd_scan(x, lw, Bm, Cm, chunk: int = 128):
    """y_t = C_t . S_t with S_t = exp(lw_t) S_{t-1} + x_t B_t^T, S_0 = 0,
    per head; x (B, T, H, dh), lw (B, T, H), Bm, Cm (B, T, N), float32.
    Within a chunk the sum over earlier steps is a masked product, across
    chunks the state is carried. Returns (B, T, H, dh)."""
    Bsz, T, H, dh = x.shape
    state = torch.zeros((Bsz, H, dh, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c0 in range(0, T, chunk):
        xc, Bc, Cc = x[:, c0:c0 + chunk], Bm[:, c0:c0 + chunk], \
            Cm[:, c0:c0 + chunk]
        cum = lw[:, c0:c0 + chunk].cumsum(1).transpose(1, 2)   # (B, H, n)
        n = cum.shape[-1]
        keep = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp((cum[..., :, None] - cum[..., None, :])
                          .masked_fill(~keep, -math.inf))      # [t, s]
        w = decay * (Cc @ Bc.transpose(1, 2))[:, None]         # (B,H,n,n)
        y = w @ xc.transpose(1, 2)                              # (B,H,n,dh)
        y = y + torch.exp(cum)[..., None] * (
            Cc[:, None] @ state.transpose(-1, -2))
        to_end = torch.exp(cum[..., -1:] - cum)                 # (B, H, n)
        state = torch.exp(cum[..., -1])[..., None, None] * state + \
            (xc.permute(0, 2, 3, 1) * to_end[:, :, None]) @ Bc[:, None]
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1)


def mamba_layer(c, x, p, precision):
    s = c["ssm"]
    D = c["d_model"]
    di, N, dh = s["expand"] * D, s["d_state"], s["d_head"]
    H = di // dh
    B, T, _ = x.shape
    proj = plain.mm(plain.rmsnorm(x, p["ln"], c["norm_eps"]), p["in_proj"],
                    precision)
    z, xbc, dt = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    K = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = p["conv_b"].float() + sum(xp[:, i:i + T] * p["conv_w"][i].float()
                                     for i in range(K))
    xin, Bm, Cm = torch.split(F.silu(conv), [di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())
    xh = xin.reshape(B, T, H, dh)
    y = ssd_scan(xh * dt[..., None], dt * -torch.exp(p["A_log"].float()),
                 Bm, Cm)
    y = (y + p["D"].float()[:, None] * xh).reshape(B, T, di) * F.silu(z)
    y = plain.rmsnorm(y, p["norm"], c["norm_eps"])
    return plain.mm(y, p["out_proj"], precision)


def shared_block(c, x, p, positions, precision):
    eps = c["norm_eps"]
    x = x + plain.attention_block(c, plain.rmsnorm(x, p["ln1"], eps),
                                  p["attn"], positions, precision)
    return x + plain.mlp(c, plain.rmsnorm(x, p["ln2"], eps), p["mlp"],
                         precision)


def logits(c, params, tokens: torch.Tensor, at, precision: str = plain.F32
           ) -> torch.Tensor:
    """(B, len(at), vocab) float32 logits of ``tokens`` (B, T) at the
    positions ``at``, each predicting the token after it."""
    every = c["shared_attn_every"]
    x = params["embed"]["tok"][tokens].float()
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    lp = params["layers"]["mamba"]
    with plain.exact_f32():
        for i in range(c["n_layers"]):
            x = x + mamba_layer(c, x, {k: v[i] for k, v in lp.items()},
                                precision)
            if i % every == every - 1:
                x = shared_block(c, x, params["shared"], pos, precision)
        x = plain.rmsnorm(x[:, list(at)], params["final_norm"],
                          c["norm_eps"])
        return plain.mm(x, params["lm_head"], precision)
