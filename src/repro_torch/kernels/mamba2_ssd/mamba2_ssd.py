"""The Mamba-2 SSD chunk scan (K6) on the H100.

Per (batch, head), over chunks of ``chunk`` steps in order, with the (dh x
N) f32 state carried across chunks (``repro/kernels/mamba2_ssd/
mamba2_ssd.py:23``, ``_ssd_kernel``)::

    cum = cumsum(lw)                        L[t, s] = exp(cum_t - cum_s), s <= t
    y   = (C B^T o L) x  +  exp(cum) o (C S0^T)
    S1  = exp(cum_T) S0 + sum_s exp(cum_T - cum_s) x_s B_s^T

``x`` is already dt-weighted and ``lw = dt * A``. A ragged last chunk is
padded with identity steps (x = 0, lw = 0), as the Pallas kernel pads. The
kernel is CUDA C++ in ``csrc/mamba2_ssd.cu`` (built by ``nvcc`` at first
use, ``kernels/_build.py``): four launches, the chunks in parallel, with
their intermediates in a workspace allocated here. :func:`ssd_chunked`
launches it for CUDA tensors and runs :func:`ssd_chunked_plain` only for
CPU tensors; under grad mode it refuses, on either device, an input that
requires grad (the kernel has no backward; ``kernels/_nograd.py``). Unlike the
Pallas kernel, both start from a given state (``None``: zero) and return
the final state, which prefill hands to decode; from a zero state ``y`` is
the Pallas kernel's ``y``.

``LAUNCHES["ssd_chunked"]`` counts kernel launches, one per call however
many CUDA kernels the call starts (never plain-version runs), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ... import obs
from .. import _build
from .._nograd import refuse_grad

MAX_WIDTH = 64             # the kernel's largest dh and N

LAUNCHES = obs.Counters("launches", "ssd_chunked")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = [_P, _I64, _I64, _I64, _P, _I64, _I64, _I64, _P, _I64, _I64,
             _P, _I64, _I64, _P, _P, _I64, _I64, _I64, _P,
             _I, _I, _I, _I, _I, _I, _P, _P]


reset_launches = LAUNCHES.reset


def _check(x, lw, Bm, Cm, chunk, state):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("lw", lw), ("Bm", Bm), ("Cm", Cm), ("state", state)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.dim() != 4 or lw.dim() != 3 or Bm.dim() != 3 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"want x (B,H,S,dh), lw (B,H,S), Bm = Cm (B,S,N); "
                         f"got {tuple(x.shape)}, {tuple(lw.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, H, S, dh = x.shape
    N = Bm.shape[-1]
    if tuple(lw.shape) != (B, H, S) or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"x {tuple(x.shape)}, lw {tuple(lw.shape)} and Bm "
                         f"{tuple(Bm.shape)} do not match")
    if state is not None and tuple(state.shape) != (B, H, dh, N):
        raise ValueError(f"state {tuple(state.shape)}, want {(B, H, dh, N)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for t in (x, lw, Bm, Cm) + (() if state is None else (state,)):
        if not t.dtype.is_floating_point:
            raise ValueError(f"unsupported dtype {t.dtype}")


def ssd_chunked_plain(x: torch.Tensor, lw: torch.Tensor, Bm: torch.Tensor,
                      Cm: torch.Tensor, *, chunk: int,
                      state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ssd_chunked`, on ``x``'s device: the
    kernel's per-chunk arithmetic with tensor ops, chunk by chunk."""
    _check(x, lw, Bm, Cm, chunk, state)
    B, H, S, dh = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    xf, lwf = x.float(), lw.float()
    Bf, Cf = Bm.float(), Cm.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        lwf = F.pad(lwf, (0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    S0 = torch.zeros((B, H, dh, N), dtype=torch.float32, device=x.device) \
        if state is None else state.float().clone()
    y = torch.empty((B, H, S + pad, dh), dtype=torch.float32,
                    device=x.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        xb, lb = xf[:, :, sl], lwf[:, :, sl]          # (B,H,T,dh), (B,H,T)
        Bb, Cb = Bf[:, sl], Cf[:, sl]                  # (B,T,N)
        cum = torch.cumsum(lb, dim=-1)
        L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)
        CB = Cb @ Bb.transpose(-1, -2)                 # (B,T,T)
        yb = (CB[:, None] * L) @ xb
        yb = yb + torch.exp(cum)[..., None] * (Cb[:, None]
                                               @ S0.transpose(-1, -2))
        w = torch.exp(cum[..., -1:] - cum)             # (B,H,T)
        S0 = torch.exp(cum[..., -1])[..., None, None] * S0 \
            + (xb * w[..., None]).transpose(-1, -2) @ Bb[:, None]
        y[:, :, sl] = yb
    return y[:, :, :S], S0


def _f32_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as f32 with a dense last dim (a copy only where it is not)."""
    t = t.float()
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def run_kernel(lib, x: torch.Tensor, lw: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, *, chunk: int,
               state: Optional[torch.Tensor] = None, stream=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Call ``repro_ssd_chunked`` of the built library ``lib`` (a
    ``ctypes.CDLL`` of ``csrc/mamba2_ssd.cu``) on checked inputs, with a
    workspace from ``torch.empty`` on x's device, and return (y, final
    state). f32 inputs with a dense last dim are read in place. ``stream``
    is a ``cudaStream_t`` handle, None for the default stream. A nonzero
    return raises. Counts no launch."""
    B, H, S, dh = x.shape
    N = Bm.shape[-1]
    x, Bm, Cm = _f32_rows(x), _f32_rows(Bm), _f32_rows(Cm)
    lw = lw.float()
    s_in = None if state is None else state.float().contiguous()
    y = torch.empty_like(x)
    s_out = torch.empty((B, H, dh, N), dtype=torch.float32, device=x.device)
    f, ws_bytes = lib.repro_ssd_chunked, lib.repro_ssd_workspace_bytes
    if f.argtypes is None:
        f.argtypes, f.restype = _ARGTYPES, ctypes.c_int
        ws_bytes.argtypes, ws_bytes.restype = [_I] * 6, ctypes.c_size_t
        lib.repro_error_string.argtypes = [_I]
        lib.repro_error_string.restype = ctypes.c_char_p
    ws = torch.empty(ws_bytes(B, H, S, dh, N, chunk), dtype=torch.uint8,
                     device=x.device)
    rc = f(x.data_ptr(), *x.stride()[:3], lw.data_ptr(), *lw.stride(),
           Bm.data_ptr(), *Bm.stride()[:2], Cm.data_ptr(), *Cm.stride()[:2],
           None if s_in is None else s_in.data_ptr(),
           y.data_ptr(), *y.stride()[:3], s_out.data_ptr(),
           B, H, S, dh, N, chunk, ws.data_ptr() if ws.numel() else None,
           stream)
    if rc:
        raise RuntimeError(f"repro_ssd_chunked failed to launch: CUDA error "
                           f"{rc} ({lib.repro_error_string(rc).decode()})")
    return y, s_out


def ssd_chunked(x: torch.Tensor, lw: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, *, chunk: int,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, H, S, dh) dt-weighted inputs; lw: (B, H, S) log-decays; Bm,
    Cm: (B, S, N); state: (B, H, dh, N) or None (zero). Any strides (e.g.
    transposed views of the model's (B, S, H, dh)); f32 inputs are read in
    place. Returns y (B, H, S, dh) f32, laid out in memory like x where x
    is dense, and the final state (B, H, dh, N) f32."""
    refuse_grad("ssd_chunked", x, lw, Bm, Cm, state)
    _check(x, lw, Bm, Cm, chunk, state)
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, lw, Bm, Cm, chunk=chunk, state=state)
    B, H, S, dh = x.shape
    N = Bm.shape[-1]
    if dh > MAX_WIDTH or N > MAX_WIDTH:
        raise ValueError(f"dh {dh} and N {N} must be at most {MAX_WIDTH}")
    if max(B * H * S * dh, B * S * N) >= 2 ** 31 or max(B, H) > 65535:
        raise ValueError(f"too large: {tuple(x.shape)}, N {N}")
    out = run_kernel(_build.load("mamba2_ssd"), x, lw, Bm, Cm, chunk=chunk,
                     state=state,
                     stream=torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES.add("ssd_chunked")
    return out
