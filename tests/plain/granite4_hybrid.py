"""Plain float32 reference of IBM Granite 4.0-H (``model_type``
granitemoehybrid; granite-4.0-h-small, 32B-A9B), from its published
config.json and the granitemoehybrid modelling code in Hugging Face
transformers.

The configuration is a dict with the config.json's keys (``hidden_size``,
``layer_types``, ``mamba_d_state``, ``num_local_experts``, ...) and
``n_layers``, the layers that run: the first ``n_layers`` of
``layer_types``. Per layer, with ``m`` = ``residual_multiplier``::

    h  = x + m * mixer(rmsnorm(x))
    x' = h + m * (moe(rmsnorm(h)) + shared(rmsnorm(h)))

* the embedding times ``embedding_multiplier``; the final RMSNorm; the
  logits from the tied embedding over ``logits_scaling``;
* attention (``layer_types`` "attention"): GQA, ``num_attention_heads`` q
  heads and ``num_key_value_heads`` kv heads of ``hidden_size /
  num_attention_heads``, no position embedding (``position_embedding_type``
  "nope"), scores times ``attention_multiplier``, causal softmax, no
  biases;
* Mamba-2 ("mamba"): one input projection to z, x, B, C and dt (one group
  of B and C), a depthwise causal conv with bias and SiLU, dt =
  softplus(dt + dt_bias), A = -exp(A_log), the SSD scan in its plain
  chunked form from a zero state, the skip D x, the gated RMSNorm
  rmsnorm(y silu(z)) over all of d_inner, the output projection;
* the MoE: router logits (a product in float32), the top
  ``num_experts_per_tok`` of them, a softmax over those; each expert a
  SwiGLU of width ``intermediate_size`` (its input projection's first half
  the gate: silu(gate) * up), computed for every token routed to it by a
  gather of those tokens (no capacity, nothing dropped) and weighted by
  its gate; the shared expert a SwiGLU of width
  ``shared_intermediate_size``.

Departures from the published model: none beyond running the first
``n_layers`` layers. Weights are the caller's (random, in a benchmark),
laid out as :func:`param_specs` gives them: projections as (in, out)
matrices, q, k and v separate, each SwiGLU's gate and up fused in one
(in, 2 width) matrix with the gate first, the experts' stacked over the
expert dim.

Everything is float32 with TF32 off. ``precision`` "fp8" rounds every
product's operands to float8 e4m3 under a per-tensor scale (the control:
the nearest precision below the bf16 the model is served in); the scan,
the norms and the softmaxes stay float32. This file imports nothing of
the program and no JAX; ``bench/reference/granite4_hybrid.py`` is a copy
of it.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

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


def mixers(c):
    """The mixer of each layer that runs."""
    return list(c["layer_types"][:c["n_layers"]])


def _widths(c):
    D = c["hidden_size"]
    di = c["mamba_expand"] * D
    H = c["mamba_n_heads"]
    if H * c["mamba_d_head"] != di or c["mamba_n_groups"] != 1:
        raise ValueError("want mamba_n_heads x mamba_d_head = d_inner and "
                         "one group of B and C")
    return D, di, H, c["mamba_d_head"], c["mamba_d_state"]


def param_specs(c):
    """The weights' layout as specs (``bench/weights.py``): ``("normal",
    shape, std)``, ``("ones", shape)``, ``("zeros", shape)``,
    ``("log_linspace", shape, lo, hi)``; the program's tree. Every matrix
    is drawn at std 1 / sqrt(its input width), so each sublayer's output
    is of the order of its input, as in a trained model; the embedding at
    0.002, so that the layers and not the prompt's last token set the
    logits (with the tied head and the x12 embedding a table of std 0.02
    or more makes a random model's top token its input's own last token,
    whatever the layers compute); Mamba-2's A_log at log(1..16) and
    dt_bias at log(0.001..0.1) (dt from 0.001 to 0.1 at a zero input), the
    Mamba-2 paper's ranges."""
    D, di, H, dh, N = _widths(c)
    mix = mixers(c)
    L, Lm, La = len(mix), mix.count("mamba"), mix.count("attention")
    V, E = c["vocab_size"], c["num_local_experts"]
    Fe, Fs = c["intermediate_size"], c["shared_intermediate_size"]
    Hq, KV = c["num_attention_heads"], c["num_key_value_heads"]
    ha = D // Hq

    def mat(*shape):
        return ("normal", shape, 1.0 / math.sqrt(shape[-2]))
    return {"embed": {"tok": ("normal", (V, D), 0.002)},
            "final_norm": ("ones", (D,)),
            "layers": {
                "mamba": {
                    "ln": ("ones", (Lm, D)),
                    "in_proj": mat(Lm, D, 2 * di + 2 * N + H),
                    "conv_w": ("normal", (Lm, c["mamba_d_conv"], di + 2 * N),
                               0.2),
                    "conv_b": ("zeros", (Lm, di + 2 * N)),
                    "A_log": ("log_linspace", (Lm, H), 1.0, 16.0),
                    "D": ("ones", (Lm, H)),
                    "dt_bias": ("log_linspace", (Lm, H), 0.001, 0.1),
                    "norm": ("ones", (Lm, di)),
                    "out_proj": mat(Lm, di, D)},
                "attention": {
                    "ln": ("ones", (La, D)),
                    "wq": mat(La, D, Hq * ha),
                    "wk": mat(La, D, KV * ha),
                    "wv": mat(La, D, KV * ha),
                    "wo": mat(La, Hq * ha, D)},
                "ln2": ("ones", (L, D)),
                "moe": {
                    "router": mat(L, D, E),
                    "w13": mat(L, E, D, 2 * Fe),
                    "w2": mat(L, E, Fe, D),
                    "shared": {"w13": mat(L, D, 2 * Fs),
                               "w2": mat(L, Fs, D)}}}}


def ssd_scan(x, lw, Bm, Cm, chunk: int):
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


def mamba_mixer(c, h, p, precision):
    """The Mamba-2 mixer of the normed residual ``h`` (B, T, D)."""
    D, di, H, dh, N = _widths(c)
    B, T, _ = h.shape
    proj = mm(h, p["in_proj"], precision)
    z, xbc, dt = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    K = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = p["conv_b"].float() + sum(xp[:, i:i + T] * p["conv_w"][i].float()
                                     for i in range(K))
    xin, Bm, Cm = torch.split(F.silu(conv), [di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())
    xh = xin.reshape(B, T, H, dh)
    y = ssd_scan(xh * dt[..., None], dt * -torch.exp(p["A_log"].float()),
                 Bm, Cm, c["mamba_chunk_size"])
    y = (y + p["D"].float()[:, None] * xh).reshape(B, T, di) * F.silu(z)
    y = rmsnorm(y, p["norm"], c["rms_norm_eps"])
    return mm(y, p["out_proj"], precision)


def attention_mixer(c, h, p, precision, block: int = 512):
    """Causal GQA of the normed residual ``h`` (B, T, D), no position
    embedding, scores times ``attention_multiplier``; float32 scores and
    softmax, blocks of ``block`` query rows."""
    B, T, _ = h.shape
    Hq, KV = c["num_attention_heads"], c["num_key_value_heads"]
    dh = c["hidden_size"] // Hq
    q, k, v = (mm(h, p[n], precision) for n in ("wq", "wk", "wv"))
    q = q.reshape(B, T, Hq, dh).permute(0, 2, 1, 3)
    k, v = (t.reshape(B, T, KV, dh).repeat_interleave(Hq // KV, dim=2)
            .permute(0, 2, 1, 3) for t in (k, v))
    o = torch.empty_like(q)
    for c0 in range(0, T, block):
        c1 = min(T, c0 + block)
        s = mm(q[:, :, c0:c1], k[:, :, :c1].transpose(-1, -2), precision) \
            * c["attention_multiplier"]
        above = torch.ones((c1 - c0, c1), dtype=torch.bool,
                           device=h.device).triu(c0 + 1)
        s.masked_fill_(above, -math.inf)
        o[:, :, c0:c1] = mm(torch.softmax(s, dim=-1), v[:, :, :c1],
                            precision)
        del s
    return mm(o.permute(0, 2, 1, 3).reshape(B, T, Hq * dh), p["wo"],
              precision)


def swiglu(h, w13, w2, precision):
    gate, up = mm(h, w13, precision).chunk(2, dim=-1)
    return mm(F.silu(gate) * up, w2, precision)


def moe(c, h, p, precision):
    """The routed experts' gated sum plus the shared expert, for the normed
    residual ``h`` (B, T, D): each expert over the tokens routed to it."""
    B, T, D = h.shape
    k = c["num_experts_per_tok"]
    x = h.reshape(B * T, D)
    top, sel = torch.topk(mm(x, p["router"], precision), k, dim=-1)
    gates = torch.softmax(top, dim=-1)                          # (BT, k)
    out = torch.zeros_like(x)
    for e in range(c["num_local_experts"]):
        rows, slot = torch.nonzero(sel == e, as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], p["w13"][e], p["w2"][e], precision)
            out.index_add_(0, rows, y * gates[rows, slot, None])
    sh = p["shared"]
    return (out + swiglu(x, sh["w13"], sh["w2"], precision)).reshape(B, T, D)


def logits(c, params, tokens: torch.Tensor, at, precision: str = F32
           ) -> torch.Tensor:
    """(B, len(at), vocab) float32 logits of ``tokens`` (B, T) at the
    positions ``at``, each predicting the token after it."""
    eps, m = c["rms_norm_eps"], c["residual_multiplier"]
    lp = params["layers"]
    x = params["embed"]["tok"][tokens].float() * c["embedding_multiplier"]
    im = ia = 0
    with exact_f32():
        for i, mixer in enumerate(mixers(c)):
            if mixer == "mamba":
                p = {n: w[im] for n, w in lp["mamba"].items()}
                x = x + m * mamba_mixer(c, rmsnorm(x, p["ln"], eps), p,
                                        precision)
                im += 1
            else:
                p = {n: w[ia] for n, w in lp["attention"].items()}
                x = x + m * attention_mixer(c, rmsnorm(x, p["ln"], eps), p,
                                            precision)
                ia += 1
            pm = {n: w[i] for n, w in lp["moe"].items() if n != "shared"}
            pm["shared"] = {n: w[i] for n, w in lp["moe"]["shared"].items()}
            x = x + m * moe(c, rmsnorm(x, lp["ln2"][i], eps), pm, precision)
        x = rmsnorm(x[:, list(at)], params["final_norm"], eps)
        return mm(x, params["embed"]["tok"].T, precision) \
            / c["logits_scaling"]
