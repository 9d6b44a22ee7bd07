"""Roofline terms of a step on an NVIDIA H100, from a dry-run record (no
card needed), as the reference's ``repro/analysis/roofline.py`` does for
its TPU:

    compute    = FLOPs a rank / peak FLOP/s
    memory     = HBM bytes a rank / HBM bytes/s
    collective = collective bytes a rank / link bytes/s

The reference's constants are a TPU v5e's; here they are an H100 SXM5's
(NVIDIA's datasheet): 989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM3, 80 GB.
The link rate is a parameter: its default is NVLink 4 within one host, 900
GB/s a GPU both ways together, so 450e9 B/s a direction; across hosts the
rate is the network's, the caller's to give.

``summarize_memory`` reads ``torch.distributed._tools.mem_tracker.
MemTracker``'s peak snapshot, where the reference reads XLA's
``memory_analysis()``. The reference's ``collective_bytes_from_hlo`` has no
counterpart: the port has no HLO, and ``analysis/comm_count.py`` records
the collectives a traced step issues.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from .flops import step_hbm_bytes

NVLINK4_BYTES_PER_S = 450e9     # H100 SXM5 datasheet: 900 GB/s both ways


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float           # dense bf16 FLOP/s per card
    hbm_bw: float               # HBM bytes/s per card
    link_bw: float              # bytes/s a direction per card
    hbm_bytes: float            # HBM capacity per card


H100 = Hardware("NVIDIA H100 SXM5", peak_flops=989e12, hbm_bw=3.35e12,
                link_bw=NVLINK4_BYTES_PER_S, hbm_bytes=80e9)


def model_flops(cfg, shape, kind: str) -> float:
    """Useful model FLOPs for the whole step (all chips):
    6·N·tokens (train), 2·N·tokens (prefill/decode); MoE uses active params."""
    n = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if kind in ("train", "prefill") else 1)
    mult = 6 if kind == "train" else 2
    return float(mult) * n * tokens


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float, hw: Hardware = H100,
                   link_bw: Optional[float] = None) -> Dict[str, float]:
    """The three terms in seconds, the largest one's name (``bound``) and
    the step's lower bound; ``link_bw`` (bytes/s) overrides ``hw``'s."""
    t_c = flops_per_chip / hw.peak_flops
    t_m = bytes_per_chip / hw.hbm_bw
    t_x = coll_bytes_per_chip / (link_bw or hw.link_bw)
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bound": dom, "step_s_lower_bound": max(t_c, t_m, t_x)}


def rank_hbm_bytes(cfg, shape, kind: str, n_chips: int, rows: int,
                   tp: int = 1) -> float:
    """HBM bytes one rank of the port moves in a step, by
    :func:`~repro_torch.analysis.flops.step_hbm_bytes`'s terms for the
    port's layout. Train: the whole bf16 copy read three times and an f32
    gradient, the optimizer state over all ``n_chips`` ranks, and the
    activations of the rank's own ``rows`` rows. Serving (the mesh steps):
    the rank's shard of the weights (1 / ``tp``, the 'model' ranks) and of
    the cache or activations (1 / ``n_chips``: rows over 'data' and the
    sequence or heads over 'model', or the sequence over every rank under
    "long"), the reference's own per-chip count."""
    if kind == "train":
        P = cfg.n_params()
        T = rows * shape.seq_len
        return (3 * P * 2 + P * 4) + 3 * P * 4 * 2 / n_chips \
            + 2 * cfg.n_layers * T * cfg.d_model * 2 * 2
    return step_hbm_bytes(cfg, shape, kind, n_chips, tp)


_KINDS = {"Parameter": "parameters", "Buffer": "buffers",
          "Gradient": "gradients", "Activation": "activations",
          "Temp": "temporaries", "Optstate": "optimizer", "Other": "other"}


def summarize_memory(peak: Mapping) -> Dict[str, int]:
    """Peak bytes by kind, summed over devices, from
    ``MemTracker.get_tracker_snapshot("peak")`` (device -> {kind: bytes,
    "Total": bytes}), and ``peak_est_bytes``, the devices' peak totals
    summed. The port has no ``nn.Module``, so its weights and state count
    as "other" (what ``track_external`` was given) and what a step makes
    as activations or temporaries."""
    out = dict.fromkeys(_KINDS.values(), 0)
    out["peak_est_bytes"] = 0
    for by_kind in peak.values():
        for k, v in by_kind.items():
            name = getattr(k, "value", k)
            if name == "Total":
                out["peak_est_bytes"] += int(v)
            else:
                out[_KINDS[name]] += int(v)
    return out
