"""Flash attention, forward (K5), on the H100.

``o = softmax(mask(q k^T / sqrt(Dh))) v`` per query row, with the masks of
the reference's Pallas kernel (``repro/kernels/flash_attention/
flash_attention.py:22``): key padding, causal ``row >= col`` and sliding
window ``row - col < window``, a masked score set to -1e30; GQA with query
head ``h`` reading kv head ``h // G``; scores, softmax and the accumulator in
f32; the output rounded once to the input dtype. The kernels are CUDA C++
in ``csrc/flash_attention.cu`` (built by ``nvcc`` at first use,
``kernels/_build.py``): bf16 on Hopper's tensor cores (TMA loads, wgmma),
which take the probabilities rounded to bf16 (as the reference model's XLA
attention does), f32 on the SIMT units in full f32. :func:`flash_attention`
launches them for CUDA tensors and runs :func:`flash_attention_plain`
(probabilities in f32, as the Pallas kernel) only for CPU tensors.

The bf16 kernel reads q, k and v through TMA tensor maps, in place where
the view allows (:func:`kernel_operand`): a (B, S, H, Dh) model layout, or
q/k/v split from a fused projection, costs no copy.

``LAUNCHES["flash_attention"]`` counts kernel launches (never plain-version
runs), so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from .. import _build
from .._nograd import refuse_grad

NEG_INF = -1e30
ATTN_CHUNK = 2048          # the reference's query chunk (models/layers.py)
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's compiled head widths

# value dtype -> code of csrc/flash_attention.cu's DType enum
_DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"flash_attention": 0}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I] + [_I64] * 12 + \
    [ctypes.c_float, _I, _I, _I64, _P]


def reset_launches():
    LAUNCHES["flash_attention"] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]):
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype} (q, k, v alike, one of "
                         f"{sorted(map(str, _DTYPE_CODES))})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,Sq,Dh), k = v (B,KV,Sk,Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, H, _, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or k.shape[1] == 0 \
            or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (H must be a multiple of KV)")


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if the kernel can read it in place, else a dense copy.
    Every kernel wants a dense last dim. The bf16 kernel loads through TMA
    tensor maps, which want the start 16-byte aligned and every stride a
    multiple of 16 bytes (8 elements); a dim of size 1 is never stepped, so
    its stride does not matter."""
    ok = t.stride(-1) == 1
    if ok and t.dtype == torch.bfloat16:
        ok = t.data_ptr() % 16 == 0 and all(
            st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
            if n > 1)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Plain version of :func:`flash_attention`, on ``q``'s device. Queries
    go in chunks of ``chunk`` rows, as the reference's attention does, so the
    f32 scores are at most (B, KV, G, chunk, Sk), never S x S."""
    _check(q, k, v, window)
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(Dh)
    kf, vf = k.float(), v.float()
    cols = torch.arange(Sk, device=q.device)
    out = torch.empty_like(q)
    for c0 in range(0, Sq, chunk):
        qc = q[:, :, c0:c0 + chunk].float()
        n = qc.shape[2]
        s = torch.einsum("begqd,bekd->begqk",
                         qc.reshape(B, KV, G, n, Dh), kf) * scale
        rows = q_offset + c0 + torch.arange(n, device=q.device)
        diff = rows[:, None] - cols[None, :]
        if causal:
            s = torch.where(diff >= 0, s, NEG_INF)
        if window is not None:
            s = torch.where(diff < window, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("begqk,bekd->begqd", p, vf)
        out[:, :, c0:c0 + n] = o.reshape(B, H, n, Dh).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, Dh); k, v: (B, KV, Sk, Dh), float32 or bfloat16, any
    strides with a dense last dim (e.g. transposed views of (B, S, H, Dh)).
    Query row i sits at position ``q_offset + i``. Returns (B, H, Sq, Dh)
    in q's dtype, laid out in memory like q."""
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not compiled (have {HEAD_DIMS})")
    if max(Sq, Sk) >= 2 ** 31 or B * H * (-(-Sq // 64)) >= 2 ** 31:
        raise ValueError(f"too many rows: {tuple(q.shape)}")
    out = run_kernel(
        functools.partial(_build.launch, "flash_attention",
                          "repro_flash_attention", _ARGTYPES),
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        stream=torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_attention"] += 1
    return out


def run_kernel(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: Optional[int] = None,
               q_offset: int = 0, stream=None) -> torch.Tensor:
    """Call ``fn`` with the arguments of the C function
    ``repro_flash_attention`` (``csrc/flash_attention.cu``) for q (B, H, Sq,
    Dh) and k, v (B, KV, Sk, Dh), each read in place where the kernel can
    (:func:`kernel_operand`), and return the output, laid out like q.
    ``fn`` is that C function of a built library (``_ARGTYPES`` set), or a
    function that calls it; a nonzero return raises. ``stream`` is a
    ``cudaStream_t`` handle, None for the default stream. Counts no
    launch."""
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    B, H, Sq, Dh = q.shape
    out = torch.empty_like(q)        # q's layout where q is dense
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, k.shape[1], Sq, k.shape[2], Dh,
            *strides, 1.0 / math.sqrt(Dh), int(causal),
            0 if window is None else int(window), int(q_offset), stream)
    if rc:
        raise RuntimeError(f"repro_flash_attention failed: error {rc}")
    return out
