"""Content-addressed processing pipelines (paper §2.3), in PyTorch.

A pipeline is a function on numpy volumes plus a canonical config; the
config's SHA-256 digest plays the role of the container image digest. Each
spec here carries ``"backend": "torch"`` in its config, so the port's
digests differ from the JAX package's: a derivative one package committed is
never taken as the other's by the provenance gate (``run_unit`` skips a unit
whose recorded digest matches).

  * bias_correct — N4-style low-order polynomial bias-field estimation
  * affine_register — gradient-descent affine registration to an atlas
  * segment_unest — UNesT-like patch-transformer tissue segmentation
    (backbone = configs/paper_unest.py, on the RMSNorm and flash-attention
    kernels)
  * dwi_prequal — MP-PCA-flavoured truncated-SVD denoising

Inputs and outputs stay numpy; the compute runs on the pipeline's device.
Products are written as elementwise multiplies and sums, so no float32
product goes through a TF32 matrix multiply; segment_unest's one float32
matmul (the patch projection) runs in full float32, torch's default
(``torch.backends.cuda.matmul.allow_tf32`` is False).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..device import DeviceLike, resolve_device
from ..models import backbone_logits, init_params


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    name: str
    version: str
    required_suffixes: Sequence[str]       # e.g. ("T1w",) or ("T1w", "dwi")
    config: Dict[str, object]

    def digest(self) -> str:
        blob = json.dumps({"name": self.name, "version": self.version,
                           "config": self.config}, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


class Pipeline:
    def __init__(self, spec: PipelineSpec,
                 fn: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]):
        self.spec = spec
        self.fn = fn

    @property
    def name(self) -> str:
        return self.spec.name

    def digest(self) -> str:
        return self.spec.digest()

    def run(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.fn(inputs)


def _linspace(n: int, device: torch.device) -> torch.Tensor:
    """``linspace(-1, 1, n)`` in float32 with the bits of XLA's compiled
    ``jnp.linspace``: ``step = iota(n-1) * (1/(n-1))``, ``out = -1 * (1 -
    step) + 1 * step``, the last point exactly 1. ``torch.linspace`` rounds
    differently, and ``affine_register`` starts where the sampler's
    ``floor`` is discontinuous, so the last bit moves its result."""
    if n <= 1:
        return torch.full((n,), -1.0, dtype=torch.float32, device=device)
    recip = torch.tensor(np.float32(1) / np.float32(n - 1), device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * recip
    out = -1.0 * (1.0 - step) + 1.0 * step
    return torch.cat([out, torch.ones(1, dtype=torch.float32, device=device)])


def _grids(shape, device) -> Tuple[torch.Tensor, ...]:
    return torch.meshgrid(*[_linspace(s, device) for s in shape],
                          indexing="ij")


def _ipow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x**k by repeated multiplication (XLA's integer_pow)."""
    out = torch.ones_like(x) if k == 0 else x
    for _ in range(k - 1):
        out = out * x
    return out


def _std(x: torch.Tensor) -> torch.Tensor:
    return x.std(correction=0)          # jnp.std is the population std


# ---------------------------------------------------------------------------
# bias-field correction (N4-style)
# ---------------------------------------------------------------------------

def _poly_basis(shape, order: int, device) -> torch.Tensor:
    gx, gy, gz = _grids(shape, device)
    basis = []
    for i in range(order + 1):
        for j in range(order + 1 - i):
            for k in range(order + 1 - i - j):
                basis.append(_ipow(gx, i) * _ipow(gy, j) * _ipow(gz, k))
    return torch.stack(basis, -1)                    # (X,Y,Z,nb)


def _fit_bias(logv: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Least-squares fit of the basis to ``logv``, by the normal equations
    in float64. ``torch.linalg.lstsq`` is not used: on CUDA its QR path
    (cuSOLVER ``ormqr``) refuses a 256x256x176 volume's 11.5M-row system
    with CUSOLVER_STATUS_INVALID_VALUE. The basis is a low-order polynomial
    on [-1, 1], well conditioned, so float64 normal equations are more
    accurate than the reference's float32 SVD solve."""
    A = basis.reshape(-1, basis.shape[-1]).to(torch.float64)
    b = logv.reshape(-1).to(torch.float64)
    coef = torch.linalg.solve(A.T @ A, A.T @ b)
    return (A @ coef).to(torch.float32).reshape(logv.shape)


def _bias_correct_fn(inputs, *, device: torch.device, order: int = 2):
    vol = torch.as_tensor(np.asarray(inputs["T1w"], np.float32),
                          device=device)
    logv = torch.log(torch.clamp(vol, min=1e-3))
    basis = _poly_basis(vol.shape, order, device)
    field = _fit_bias(logv - logv.mean(), basis)
    corrected = torch.exp(logv - field)
    return {"T1w_biascorr": corrected.cpu().numpy(),
            "bias_field": torch.exp(field).cpu().numpy()}


# ---------------------------------------------------------------------------
# affine registration to a synthetic atlas
# ---------------------------------------------------------------------------

def _affine_grid(shape, theta: torch.Tensor, grids) -> List[torch.Tensor]:
    """theta: (3,4) affine. Returns the warped sampling coords in voxels,
    one (X,Y,Z) tensor per axis: ``(coords @ theta.T + 1) * (shape-1)/2``
    with ``coords = (gx, gy, gz, 1)``, the 4-term product written out."""
    gx, gy, gz = grids
    out = []
    for c, s in enumerate(shape):
        w = gx * theta[c, 0] + gy * theta[c, 1] + gz * theta[c, 2] \
            + theta[c, 3]
        scale = (torch.tensor(float(s), dtype=torch.float32) - 1) / 2
        out.append((w + 1) * scale.to(w.device))
    return out


def _trilinear(vol: torch.Tensor, coords: List[torch.Tensor]) -> torch.Tensor:
    X, Y, Z = vol.shape
    flat = vol.reshape(-1)
    x, y, z = coords
    x0, y0, z0 = (torch.clamp(torch.floor(c).to(torch.int64), 0, s - 2)
                  for c, s in zip((x, y, z), vol.shape))
    dx, dy, dz = x - x0, y - y0, z - z0
    out = 0.0
    for ix, wx in ((x0, 1 - dx), (x0 + 1, dx)):
        for iy, wy in ((y0, 1 - dy), (y0 + 1, dy)):
            for iz, wz in ((z0, 1 - dz), (z0 + 1, dz)):
                out = out + flat[(ix * Y + iy) * Z + iz] * wx * wy * wz
    return out


def _register_fn(inputs, *, device: torch.device, steps: int = 60,
                 lr: float = 5e-3):
    moving = torch.as_tensor(np.asarray(inputs["T1w"], np.float32),
                             device=device)
    moving = (moving - moving.mean()) / (_std(moving) + 1e-6)
    # synthetic atlas: centered sphere intensity prior
    shape = tuple(moving.shape)
    grids = _grids(shape, device)
    gx, gy, gz = grids
    atlas = torch.exp(-4 * (_ipow(gx, 2) + _ipow(gy, 2) + _ipow(gz, 2)))
    atlas = (atlas - atlas.mean()) / (_std(atlas) + 1e-6)

    def loss(theta):
        warped = _trilinear(moving, _affine_grid(shape, theta, grids))
        return _ipow(warped - atlas, 2).mean()

    theta = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1).to(device)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
    losses = []
    for _ in range(steps):                 # the reference's scan, unrolled
        th = theta.detach().requires_grad_(True)
        val = loss(th)
        grad, = torch.autograd.grad(val, th)
        losses.append(val.detach())
        theta = theta - lr_t * grad
    with torch.no_grad():
        warped = _trilinear(moving, _affine_grid(shape, theta, grids))
    return {"T1w_reg": warped.cpu().numpy(),
            "affine": theta.cpu().numpy(),
            "reg_loss": torch.stack(losses).cpu().numpy()}


# ---------------------------------------------------------------------------
# UNesT-like segmentation (transformer backbone over 3D patches)
# ---------------------------------------------------------------------------

def segment_logits(vol: torch.Tensor, cfg, params, proj: torch.Tensor,
                   patch: int) -> torch.Tensor:
    """Logits (npatch, vocab) of the backbone over ``vol``'s patches:
    patchify, normalise, project (float32), run the stack in bfloat16,
    final rmsnorm, head. ``npatch = prod(vol.shape // patch)``."""
    X, Y, Z = vol.shape
    px, py, pz = X // patch, Y // patch, Z // patch
    patches = vol[:px * patch, :py * patch, :pz * patch] \
        .reshape(px, patch, py, patch, pz, patch) \
        .permute(0, 2, 4, 1, 3, 5).reshape(px * py * pz, patch ** 3)
    patches = (patches - patches.mean()) / (_std(patches) + 1e-6)
    x = (patches @ proj)[None].to(torch.bfloat16)        # (1, npatch, D)
    return backbone_logits(cfg, params, x)[0]


def _segment_fn(inputs, *, device: torch.device, n_classes: int = 4,
                patch: int = 4, seed: int = 0, params=None, proj=None):
    """The reference's ``_segment_fn``. ``params`` and ``proj`` default to
    weights drawn from CPU ``torch.Generator``s seeded ``seed`` and
    ``seed + 1`` (the same on every device; not the reference's
    ``jax.random`` weights, which a caller converts with
    ``repro_torch.convert.from_jax`` and passes in)."""
    vol = torch.as_tensor(np.asarray(inputs["T1w"], np.float32),
                          device=device)
    cfg = get_config("paper-unest").reduced(vocab_size=max(n_classes, 8))
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             device=device)
    if proj is None:
        proj = torch.randn((patch ** 3, cfg.d_model),
                           generator=torch.Generator().manual_seed(seed + 1))
        proj = (proj / patch ** 1.5).to(device)
    with torch.inference_mode():
        logits = segment_logits(vol, cfg, params, proj, patch)[:, :n_classes]
        grid = [s // patch for s in vol.shape]
        seg = torch.argmax(logits, -1).reshape(grid)
        for axis in range(3):
            seg = torch.repeat_interleave(seg, patch, dim=axis)
    return {"segmentation": seg.to(torch.int32).cpu().numpy(),
            "class_logits": logits.to(torch.float32).cpu().numpy()}


# ---------------------------------------------------------------------------
# DWI denoising (PreQual stand-in)
# ---------------------------------------------------------------------------

def _pca_denoise_fn(inputs, *, device: torch.device, keep: int = 3):
    """MP-PCA-flavoured denoising: truncated SVD over the volume dimension,
    the rank-``keep`` reconstruction summed term by term."""
    dwi = np.asarray(inputs["dwi"])
    X, Y, Z, V = dwi.shape
    flat = torch.as_tensor(dwi.reshape(-1, V).astype(np.float32),
                           device=device)
    mu = flat.mean(0)
    u, s, vt = torch.linalg.svd(flat - mu, full_matrices=False)
    out = torch.zeros_like(flat)
    for j in range(min(keep, s.numel())):
        out = out + (u[:, j] * s[j])[:, None] * vt[j][None, :]
    return {"dwi_denoised": (out + mu).reshape(X, Y, Z, V).cpu().numpy()}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def builtin_pipelines(device: DeviceLike = None) -> Dict[str, Pipeline]:
    """The port's pipelines on ``device`` (``None`` means ``cuda``, which
    must exist)."""
    dev = resolve_device(device)
    return {
        "bias_correct": Pipeline(
            PipelineSpec("bias_correct", "1.0", ("T1w",),
                         {"order": 2, "backend": "torch"}),
            functools.partial(_bias_correct_fn, device=dev)),
        "affine_register": Pipeline(
            PipelineSpec("affine_register", "1.0", ("T1w",),
                         {"steps": 60, "lr": 5e-3, "backend": "torch"}),
            functools.partial(_register_fn, device=dev)),
        "segment_unest": Pipeline(
            PipelineSpec("segment_unest", "1.0", ("T1w",),
                         {"n_classes": 4, "patch": 4, "backend": "torch"}),
            functools.partial(_segment_fn, device=dev)),
        "dwi_prequal": Pipeline(
            PipelineSpec("dwi_prequal", "1.0", ("T1w", "dwi"),
                         {"denoise": "pca", "backend": "torch"}),
            functools.partial(_pca_denoise_fn, device=dev)),
    }
