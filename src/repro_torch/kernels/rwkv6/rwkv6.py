"""The RWKV-6 chunked WKV (K7) on the H100.

Per (batch, head), over chunks of ``chunk`` steps in order, with the (dh x
dh) f32 state carried across chunks (``repro/kernels/rwkv6/rwkv6.py:20``,
``_wkv_kernel``)::

    cum = cumsum(lw), cumex = cum - lw
    out_t = sum_{s<t} [sum_d r_t k_s exp(cumex_t - cum_s)] v_s
            + (sum_d u r_t k_t) v_t + (r_t o exp(cumex_t)) S0
    S1 = diag(exp(cum_T)) S0 + sum_s (k_s o exp(cum_T - cum_s))^T v_s

A decay is only ever one exponential of a difference (<= 1): split into
exp(cumex) exp(-cum) it overflows, since lw reaches -20 per step. A ragged
last chunk is padded with identity steps (r = k = v = 0, lw = 0), as the
Pallas kernel pads. The kernel is CUDA C++ in ``csrc/rwkv6.cu`` (built by
``nvcc`` at first use, ``kernels/_build.py``): three launches, the chunks
in parallel, with their intermediates in a workspace allocated here; it
factors the decays around 16-step sub-chunks. :func:`wkv6_chunked`
launches it for CUDA tensors and runs :func:`wkv6_chunked_plain` only for
CPU tensors. Unlike the Pallas kernel, both start from a given state
(``None``: zero) and return the final state; from a zero state ``out`` is
the Pallas kernel's ``out``.

``LAUNCHES["wkv6_chunked"]`` counts kernel launches, one per call however
many CUDA kernels the call starts (never plain-version runs), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .._nograd import refuse_grad

MAX_WIDTH = 64             # the kernel's largest dh

# r, k, v dtype -> code of csrc/rwkv6.cu's DType enum
_DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"wkv6_chunked": 0}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = [_P, _I64, _I64, _I64] * 4 + [_P, _P, _P, _I64, _I64, _I64, _P,
                                          _I, _I, _I, _I, _I, _I, _P, _P]


def reset_launches():
    LAUNCHES["wkv6_chunked"] = 0


def _check(r, k, v, logw, u, chunk, state):
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {r.device}")
    for name, t in (("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("state", state)):
        if t is not None and t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or logw.shape != r.shape:
        raise ValueError(f"want r = k = v = logw (B,H,S,dh); got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(logw.shape)}")
    B, H, S, dh = r.shape
    if tuple(u.shape) != (H, dh):
        raise ValueError(f"u {tuple(u.shape)}, want {(H, dh)}")
    if state is not None and tuple(state.shape) != (B, H, dh, dh):
        raise ValueError(f"state {tuple(state.shape)}, want "
                         f"{(B, H, dh, dh)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for t in (r, k, v, logw, u) + (() if state is None else (state,)):
        if not t.dtype.is_floating_point:
            raise ValueError(f"unsupported dtype {t.dtype}")


def wkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor, *, chunk: int,
                       state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`wkv6_chunked`, on ``r``'s device: the
    kernel's per-chunk arithmetic with tensor ops, chunk by chunk (it forms
    the (B, H, T, T, dh) decay tensor that the kernel never holds)."""
    _check(r, k, v, logw, u, chunk, state)
    B, H, S, dh = r.shape
    pad = (-S) % chunk
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, logw))
    if pad:
        rf, kf, vf, lwf = (F.pad(t, (0, 0, 0, pad))
                           for t in (rf, kf, vf, lwf))
    uf = u.float()
    S0 = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device) \
        if state is None else state.float().clone()
    out = torch.empty((B, H, S + pad, dh), dtype=torch.float32,
                      device=r.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        rb, kb, vb, lb = (t[:, :, sl] for t in (rf, kf, vf, lwf))
        cum = torch.cumsum(lb, dim=2)
        cumex = cum - lb
        decay = torch.exp(cumex[:, :, :, None, :] - cum[:, :, None, :, :])
        scores = ((rb[:, :, :, None, :] * kb[:, :, None, :, :])
                  * decay).sum(-1)
        scores = torch.where(tri, scores, 0.0)
        diag = (uf[:, None, :] * rb * kb).sum(-1)
        ob = scores @ vb + diag[..., None] * vb
        ob = ob + (rb * torch.exp(cumex)) @ S0
        pT = torch.exp(cum[:, :, -1])                  # (B,H,dh)
        ksc = kb * torch.exp(cum[:, :, -1:, :] - cum)
        S0 = pT[..., None] * S0 + ksc.transpose(-1, -2) @ vb
        out[:, :, sl] = ob
    return out[:, :, :S], S0


def _dense_rows(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def run_kernel(lib, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, *, chunk: int,
               state: Optional[torch.Tensor] = None, stream=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Call ``repro_wkv6_chunked`` of the built library ``lib`` (a
    ``ctypes.CDLL`` of ``csrc/rwkv6.cu``) on checked inputs (r, k, v of one
    dtype in ``_DTYPE_CODES``), with a workspace from ``torch.empty`` on r's
    device, and return (out, final state). Inputs with a dense last dim are
    read in place. ``stream`` is a ``cudaStream_t`` handle, None for the
    default stream. A nonzero return raises. Counts no launch."""
    B, H, S, dh = r.shape
    r, k, v = (_dense_rows(t) for t in (r, k, v))
    logw = _dense_rows(logw.float())
    uf = u.float().contiguous()
    s_in = None if state is None else state.float().contiguous()
    out = torch.empty_like(r, dtype=torch.float32)
    s_out = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    f, ws_bytes = lib.repro_wkv6_chunked, lib.repro_wkv6_workspace_bytes
    if f.argtypes is None:
        f.argtypes, f.restype = _ARGTYPES, ctypes.c_int
        ws_bytes.argtypes, ws_bytes.restype = [_I] * 5, ctypes.c_size_t
        lib.repro_error_string.argtypes = [_I]
        lib.repro_error_string.restype = ctypes.c_char_p
    ws = torch.empty(ws_bytes(B, H, S, dh, chunk), dtype=torch.uint8,
                     device=r.device)
    rc = f(r.data_ptr(), *r.stride()[:3], k.data_ptr(), *k.stride()[:3],
           v.data_ptr(), *v.stride()[:3], logw.data_ptr(),
           *logw.stride()[:3], uf.data_ptr(),
           None if s_in is None else s_in.data_ptr(),
           out.data_ptr(), *out.stride()[:3], s_out.data_ptr(),
           B, H, S, dh, chunk, _DTYPE_CODES[r.dtype],
           ws.data_ptr() if ws.numel() else None, stream)
    if rc:
        raise RuntimeError(f"repro_wkv6_chunked failed to launch: CUDA error "
                           f"{rc} ({lib.repro_error_string(rc).decode()})")
    return out, s_out


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, *, chunk: int,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, H, S, dh) float32 or bfloat16, one dtype; logw:
    (B, H, S, dh) log-decays (read as f32); u: (H, dh); state: (B, H, dh,
    dh) or None (zero). Any strides (e.g. transposed views of the model's
    (B, S, H, dh)); r, k, v and an f32 logw are read in place. Returns out
    (B, H, S, dh) f32, laid out in memory like r where r is dense, and the
    final state (B, H, dh, dh) f32."""
    refuse_grad("wkv6_chunked", r, k, v, logw, u, state)
    _check(r, k, v, logw, u, chunk, state)
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, logw, u, chunk=chunk, state=state)
    B, H, S, dh = r.shape
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"unsupported dtypes {r.dtype}, {k.dtype}, "
                         f"{v.dtype} (r, k, v alike, one of "
                         f"{sorted(map(str, _DTYPE_CODES))})")
    if dh > MAX_WIDTH:
        raise ValueError(f"dh {dh} must be at most {MAX_WIDTH}")
    if B * H * S * dh >= 2 ** 31 or max(B, H) > 65535:
        raise ValueError(f"too large: {tuple(r.shape)}")
    out = run_kernel(_build.load("rwkv6"), r, k, v, logw, u, chunk=chunk,
                     state=state,
                     stream=torch.cuda.current_stream(r.device).cuda_stream)
    LAUNCHES["wkv6_chunked"] += 1
    return out
