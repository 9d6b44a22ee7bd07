"""The Mamba-2 layer's elementwise glue around the SSD scan (K6) on the H100.

Two kernels for a bf16 serving prefill (``models/mamba2._mixer``), one on
each side of K6, in CUDA C++ (``csrc/mamba2_glue.cu``, built by ``nvcc`` at
first use, ``kernels/_build.py``). They replace no TPU kernel: the reference
leaves this glue to XLA.

* :func:`mamba2_conv_in` reads ``in_proj``'s conv and dt columns in place
  and the conv state, and writes the scan's f32 inputs: the depthwise causal
  conv, its bias and SiLU in bf16 (each product and partial sum rounded, in
  the reference's order), ``dt = softplus(dt + dt_bias)`` and ``lw = dt *
  -exp(A_log)`` in f32, ``xs = f32(xh) * dt``, B and C in f32, ``xh`` in
  bf16 for the D skip, and the new conv state.
* :func:`mamba2_gate_norm` reads the scan's f32 ``y``, ``xh``, ``z`` (in
  place), ``D`` and the norm's scale, and writes ``rmsnorm(bf16(bf16(y + D
  xh) * bf16(silu(z))))``: K4 (``kernels/rmsnorm``) fused with the gate, in
  K4's order of the sum of squares.

Each rounds to bf16 where the torch ops it replaces round, so on the card
its outputs are its plain version's bit for bit; :func:`mamba2_conv_in_plain`
and :func:`mamba2_gate_norm_plain` are those ops. A wrapper launches its
kernel once a call for a CUDA tensor and runs the plain version only for a
CPU tensor; under grad mode it refuses, on either device, an input that
requires grad (``kernels/_nograd.py``). ``LAUNCHES`` counts kernel launches
by wrapper (never plain-version runs).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ... import obs
from .. import _build
from .._nograd import refuse_grad
from ..rmsnorm import rmsnorm_plain

LAUNCHES = obs.Counters("launches", "mamba2_conv_in", "mamba2_gate_norm")
reset_launches = LAUNCHES.reset

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_CONV_IN_ARGS = [_P, _P, _I64, _I64, _P, _P, _I, _P, _I, _P, _I, _P, _I,
                 _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_GATE_NORM_ARGS = [_P, _P, _P, _I64, _I64, _P, _I, _P, _I, _P, _I, _I, _I,
                   _I, ctypes.c_float, _P]
_PARAMS = (torch.float32, torch.bfloat16)


def takes(d_inner: int, d_state: int, n_heads: int, d_conv: int) -> bool:
    """Whether the kernels take a layer of these widths: 8-channel (16-byte)
    groups that never straddle a head or the x / B / C boundary, rows of
    ``in_proj``'s output (2 d_inner + 2 d_state + n_heads values) 16-byte
    aligned, a conv of 2 to 4 taps, a norm of at most 4,096 groups."""
    return (n_heads >= 1 and n_heads % 8 == 0 and d_inner % n_heads == 0
            and (d_inner // n_heads) % 8 == 0 and d_state % 8 == 0
            and 2 <= d_conv <= 4 and d_inner <= 8 * 4096)


def mamba2_conv_in_plain(conv_in: torch.Tensor, dt: torch.Tensor,
                         conv_state: Optional[torch.Tensor],
                         conv_w: torch.Tensor, conv_b: torch.Tensor,
                         dt_bias: torch.Tensor, a_log: torch.Tensor, *,
                         d_state: int):
    """Plain version of :func:`mamba2_conv_in`: the model's torch ops."""
    B, S, C = conv_in.shape
    H = dt.shape[-1]
    K = conv_w.shape[0]
    di = C - 2 * d_state
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, C), dtype=conv_in.dtype,
                                 device=conv_in.device)
    xp = torch.cat([conv_state, conv_in], dim=1)
    wx = conv_w.to(conv_in.dtype)
    y = xp[:, 0:S] * wx[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * wx[i]
    act = F.silu(y + conv_b.to(conv_in.dtype))
    xh, Bm, Cm = torch.split(act, [di, d_state, d_state], dim=-1)
    dtf = F.softplus(dt.float() + dt_bias.float())
    lw = dtf * -torch.exp(a_log.float())
    xs = xh.float().reshape(B, S, H, di // H) * dtf[..., None]
    return (xs, lw, Bm.float(), Cm.float(), xh.contiguous(),
            xp[:, -(K - 1):].clone())


def mamba2_gate_norm_plain(y: torch.Tensor, xh: torch.Tensor,
                           z: torch.Tensor, D: torch.Tensor,
                           scale: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`mamba2_gate_norm`: the model's torch ops,
    with K4's plain version (its order of the sum of squares)."""
    B, S, H, dh = y.shape
    v = y + D.float()[None, None, :, None] * \
        xh.float().reshape(B, S, H, dh)
    g = v.reshape(B, S, H * dh).to(z.dtype) * F.silu(z)
    return rmsnorm_plain(g, scale, eps)


def _code(t: torch.Tensor) -> int:
    """1 for a bf16 parameter, 0 for an f32 one."""
    return int(t.dtype == torch.bfloat16)


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_params(device, *params):
    for t in params:
        if t.device != device:
            raise ValueError(f"a parameter on {t.device}, the input on "
                             f"{device}")
        if t.dtype not in _PARAMS:
            raise ValueError(f"unsupported parameter dtype {t.dtype} "
                             f"(supported: float32, bfloat16)")


def _rows_in_place(t: torch.Tensor, what: str, align: int):
    """Refuse a (B, S, n) bf16 view whose rows the kernel cannot read in
    place: the last dim dense, the start and the row strides ``align``-byte
    aligned."""
    if t.stride(-1) != 1 or t.data_ptr() % align \
            or t.stride(0) % (align // 2) or t.stride(1) % (align // 2):
        raise ValueError(f"{what} {tuple(t.shape)} with strides "
                         f"{t.stride()} is not a view of {align}-byte-"
                         f"aligned rows")


def run_conv_in(lib: ctypes.CDLL, conv_in, dt, conv_state, conv_w, conv_b,
                dt_bias, a_log, *, d_state: int, stream=None):
    """One call of ``repro_mamba2_conv_in`` of the built library ``lib`` (a
    ``ctypes.CDLL`` of ``csrc/mamba2_glue.cu``) on checked inputs (as
    :func:`mamba2_conv_in` takes them), with its outputs from
    ``torch.empty`` on their device. ``stream`` is a ``cudaStream_t``
    handle, None for the default stream. A nonzero return raises. Counts
    no launch."""
    B, S, C = conv_in.shape
    H = dt.shape[-1]
    K = conv_w.shape[0]
    di = C - 2 * d_state
    if conv_state is not None:
        conv_state = conv_state.contiguous()
    w, cb = conv_w.contiguous(), conv_b.contiguous()
    dtb, al = dt_bias.contiguous(), a_log.contiguous()
    f32 = dict(dtype=torch.float32, device=conv_in.device)
    bf16 = dict(dtype=torch.bfloat16, device=conv_in.device)
    xs = torch.empty((B, S, H, di // H), **f32)
    lw = torch.empty((B, S, H), **f32)
    Bm = torch.empty((B, S, d_state), **f32)
    Cm = torch.empty((B, S, d_state), **f32)
    xh = torch.empty((B, S, di), **bf16)
    new_state = torch.empty((B, K - 1, C), **bf16)
    _build.call(
        lib, "repro_mamba2_conv_in", _CONV_IN_ARGS, conv_in.data_ptr(),
        dt.data_ptr(), conv_in.stride(0), conv_in.stride(1),
        None if conv_state is None else conv_state.data_ptr(), w.data_ptr(),
        _code(w), cb.data_ptr(), _code(cb), dtb.data_ptr(), _code(dtb),
        al.data_ptr(), _code(al), xs.data_ptr(), lw.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), xh.data_ptr(), new_state.data_ptr(),
        B, S, di, d_state, H, K, stream)
    return xs, lw, Bm, Cm, xh, new_state


def run_gate_norm(lib: ctypes.CDLL, y, xh, z, D, scale, eps: float = 1e-5,
                  *, stream=None) -> torch.Tensor:
    """One call of ``repro_mamba2_gate_norm`` of ``lib`` on checked inputs
    (as :func:`mamba2_gate_norm` takes them); the output from
    ``torch.empty``. As :func:`run_conv_in` otherwise."""
    B, S, H, dh = y.shape
    y, xh = y.contiguous(), xh.contiguous()
    Dc, sc = D.contiguous(), scale.contiguous()
    out = torch.empty((B, S, H * dh), dtype=torch.bfloat16, device=y.device)
    _build.call(
        lib, "repro_mamba2_gate_norm", _GATE_NORM_ARGS, y.data_ptr(),
        xh.data_ptr(), z.data_ptr(), z.stride(0), z.stride(1), Dc.data_ptr(),
        _code(Dc), sc.data_ptr(), _code(sc), out.data_ptr(), B, S, H * dh, H,
        eps, stream)
    return out


def mamba2_conv_in(conv_in: torch.Tensor, dt: torch.Tensor,
                   conv_state: Optional[torch.Tensor], conv_w: torch.Tensor,
                   conv_b: torch.Tensor, dt_bias: torch.Tensor,
                   a_log: torch.Tensor, *, d_state: int):
    """The glue before K6. conv_in: (B, S, d_inner + 2 d_state) bf16 and dt:
    (B, S, H) bf16, views of ``in_proj``'s output read in place; conv_state:
    (B, K-1, d_inner + 2 d_state) bf16 or None (zero); conv_w: (K, d_inner +
    2 d_state), conv_b: (d_inner + 2 d_state,), dt_bias, a_log: (H,), each
    f32 or bf16. Returns (xs (B, S, H, dh) f32, lw (B, S, H) f32, Bm, Cm
    (B, S, d_state) f32, xh (B, S, d_inner) bf16, the new conv state), all
    contiguous."""
    refuse_grad("mamba2_conv_in", conv_in, dt, conv_state, conv_w, conv_b,
                dt_bias, a_log)
    B, S, C = conv_in.shape
    H = dt.shape[-1]
    K = conv_w.shape[0]
    di = C - 2 * d_state
    if tuple(dt.shape[:2]) != (B, S) or di < 1 \
            or not takes(di, d_state, H, K) \
            or tuple(conv_w.shape) != (K, C) \
            or tuple(conv_b.shape) != (C,) \
            or tuple(dt_bias.shape) != (H,) or tuple(a_log.shape) != (H,) \
            or (conv_state is not None
                and tuple(conv_state.shape) != (B, K - 1, C)):
        raise ValueError(f"the kernel does not take conv_in "
                         f"{tuple(conv_in.shape)}, dt {tuple(dt.shape)}, "
                         f"conv_w {tuple(conv_w.shape)}, d_state {d_state}")
    if conv_in.device.type == "cpu":
        return mamba2_conv_in_plain(conv_in, dt, conv_state, conv_w, conv_b,
                                    dt_bias, a_log, d_state=d_state)
    if conv_in.device.type != "cuda":
        raise ValueError(f"unsupported device {conv_in.device}")
    for t in (dt, conv_state):
        if t is not None and (t.dtype != torch.bfloat16
                              or t.device != conv_in.device):
            raise ValueError(f"conv_in, dt and conv_state must be bfloat16 "
                             f"on one device, got {t.dtype} on {t.device}")
    if conv_in.dtype != torch.bfloat16:
        raise ValueError(f"conv_in must be bfloat16, got {conv_in.dtype}")
    if conv_in.stride()[:2] != dt.stride()[:2] or dt.stride(-1) != 1:
        raise ValueError("conv_in and dt must be columns of one tensor")
    _rows_in_place(conv_in, "conv_in", 8)
    _check_params(conv_in.device, conv_w, conv_b, dt_bias, a_log)
    out = run_conv_in(_build.load("mamba2_glue"), conv_in, dt, conv_state,
                      conv_w, conv_b, dt_bias, a_log, d_state=d_state,
                      stream=_stream(conv_in))
    if B * S:
        LAUNCHES.add("mamba2_conv_in")
    return out


def mamba2_gate_norm(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                     D: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """The glue after K6. y: (B, S, H, dh) f32, the scan's output; xh: (B,
    S, H dh) bf16; z: (B, S, H dh) bf16, a view of ``in_proj``'s output read
    in place; D: (H,), scale: (H dh,), f32 or bf16. Returns ``rmsnorm(bf16(
    bf16(y + D xh) * bf16(silu(z))), scale, eps)``, (B, S, H dh) bf16."""
    refuse_grad("mamba2_gate_norm", y, xh, z, D, scale)
    B, S, H, dh = y.shape
    d = H * dh
    if tuple(xh.shape) != (B, S, d) or tuple(z.shape) != (B, S, d) \
            or tuple(D.shape) != (H,) or tuple(scale.shape) != (d,) \
            or dh % 8 or d > 8 * 4096:
        raise ValueError(f"the kernel does not take y {tuple(y.shape)}, xh "
                         f"{tuple(xh.shape)}, z {tuple(z.shape)}, D "
                         f"{tuple(D.shape)}, scale {tuple(scale.shape)}")
    if y.device.type == "cpu":
        return mamba2_gate_norm_plain(y, xh, z, D, scale, eps)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype != torch.float32 or xh.dtype != torch.bfloat16 \
            or z.dtype != torch.bfloat16:
        raise ValueError(f"want y float32, xh and z bfloat16; got "
                         f"{y.dtype}, {xh.dtype}, {z.dtype}")
    _check_params(y.device, D, scale)
    for t in (xh, z):
        if t.device != y.device:
            raise ValueError(f"an input on {t.device}, y on {y.device}")
    _rows_in_place(z, "z", 16)
    out = run_gate_norm(_build.load("mamba2_glue"), y, xh, z, D, scale, eps,
                        stream=_stream(y))
    if B * S:
        LAUNCHES.add("mamba2_gate_norm")
    return out
