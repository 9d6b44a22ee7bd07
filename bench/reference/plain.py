"""What the references share: products in float32 (TF32 off) or, for the
control, with their operands rounded to float8 e4m3 (per-tensor scale, the
nearest precision below the bf16 the configurations state); RMSNorm; RoPE;
causal attention in blocks of query rows; the fused-weight split."""
from __future__ import annotations

import contextlib
import math
from typing import List, Sequence

import torch

F32, FP8 = "f32", "fp8"
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products in full float32: TF32 off for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` in float32 as a product takes it: exact, or rounded to e4m3
    under a per-tensor scale that maps its largest magnitude to 448."""
    x = x.float()
    if precision == F32:
        return x
    scale = E4M3_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return operand(a, precision) @ operand(b, precision)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotate-half RoPE of x (..., S, H, Dh) at ``positions`` (S,): the
    frequencies ``theta ** (-2i / Dh)`` and the angles in float32, as the
    model defines them."""
    dh = x.shape[-1]
    freqs = (theta ** (-torch.arange(0, dh, 2, dtype=torch.float64) / dh)
             ).to(torch.float32).to(x.device)
    ang = positions.to(torch.float32)[:, None] * freqs       # (S, dh/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     precision: str, block: int = 2048) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh), causal) v for q (B, S, H, Dh) and k, v (B,
    S, KV, Dh), query head h reading kv head h // (H / KV); float32
    scores and softmax, blocks of ``block`` query rows over the keys up to
    the block's end. Returns (B, S, H, Dh) float32."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    qh = q.float().permute(0, 2, 1, 3).reshape(B * H, S, dh)
    kh, vh = (t.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
              .reshape(B * H, S, dh) for t in (k, v))
    out = torch.empty_like(qh)
    scale = 1.0 / math.sqrt(dh)
    for c0 in range(0, S, block):
        c1 = min(S, c0 + block)
        s = mm(qh[:, c0:c1], kh[:, :c1].transpose(1, 2), precision) * scale
        above = torch.ones((c1 - c0, c1 - c0), dtype=torch.bool,
                           device=q.device).triu(1)
        s[:, :, c0:c1].masked_fill_(above, -math.inf)
        p = torch.softmax(s, dim=-1)
        del s
        out[:, c0:c1] = mm(p, vh[:, :c1], precision)
        del p
    return out.reshape(B, H, S, dh).permute(0, 2, 1, 3)


def split_fused(x: torch.Tensor, widths: Sequence[int],
                interleave: int) -> List[torch.Tensor]:
    """The last dim of a fused projection's output split into ``widths``:
    laid out in ``interleave`` blocks of [w0/t | w1/t | ...] where every
    width divides by t, else plainly one after another."""
    t = interleave
    if t <= 1 or any(w % t for w in widths):
        return list(torch.split(x, list(widths), dim=-1))
    xr = x.reshape(x.shape[:-1] + (t, x.shape[-1] // t))
    parts, off = [], 0
    for w in widths:
        parts.append(xr[..., off:off + w // t].reshape(x.shape[:-1] + (w,)))
        off += w // t
    return parts


def qkv_fused(c) -> bool:
    """Whether q, k and v share one ``wqkv`` (every head count and width
    divides by ``tp_fuse``)."""
    t = c["tp_fuse"]
    H, KV, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
    return t > 1 and H % t == 0 and H * dh % t == 0 and KV * dh % t == 0


def attn_specs(c, L):
    """The attention weights' specs (``bench/weights.py``), stacked over
    ``L`` layers (an empty tuple: one block)."""
    D, H, KV, dh = c["d_model"], c["n_heads"], c["n_kv_heads"], c["d_head"]
    out = 0.02 / math.sqrt(2 * c["n_layers"])
    if qkv_fused(c):
        return {"wqkv": ("normal", L + (D, (H + 2 * KV) * dh), 0.02),
                "wo": ("normal", L + (H * dh, D), out)}
    return {"wq": ("normal", L + (D, H * dh), 0.02),
            "wk": ("normal", L + (D, KV * dh), 0.02),
            "wv": ("normal", L + (D, KV * dh), 0.02),
            "wo": ("normal", L + (H * dh, D), out)}


def mlp_specs(c, L):
    """SwiGLU's weights' specs: gate and up fused in ``w13``."""
    D, F = c["d_model"], c["d_ff"]
    out = 0.02 / math.sqrt(2 * c["n_layers"])
    return {"w13": ("normal", L + (D, 2 * F), 0.02),
            "w2": ("normal", L + (F, D), out)}


def attention_block(c, h: torch.Tensor, p, positions: torch.Tensor,
                    precision: str) -> torch.Tensor:
    """Projections, RoPE, causal attention and ``wo`` of the normed
    residual ``h`` (B, S, D)."""
    B, S, _ = h.shape
    H, KV, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
    if "wqkv" in p:
        q, k, v = split_fused(mm(h, p["wqkv"], precision),
                              [H * dh, KV * dh, KV * dh], c["tp_fuse"])
    else:
        q, k, v = (mm(h, p[n], precision) for n in ("wq", "wk", "wv"))
    q, k, v = (t.reshape(B, S, -1, dh) for t in (q, k, v))
    q = rope(q, positions, c["rope_theta"])
    k = rope(k, positions, c["rope_theta"])
    o = causal_attention(q, k, v, precision)
    return mm(o.reshape(B, S, H * dh), p["wo"], precision)


def mlp(c, h: torch.Tensor, p, precision: str) -> torch.Tensor:
    """SwiGLU, ``w13`` split as the fused layout says."""
    gu = mm(h, p["w13"], precision)
    gate, up = split_fused(gu, [gu.shape[-1] // 2] * 2, c["tp_fuse"])
    return mm(torch.nn.functional.silu(gate) * up, p["w2"], precision)
