"""Model/arch configuration system.

Every assigned architecture is a ``ModelConfig``. Configs are immutable
dataclasses; their canonical JSON serialization is hashed to produce the
"container digest" used for provenance (the paper's Singularity-image
content-address, adapted — see DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # layers where MoE replaces the dense MLP; "all" or every Nth
    every: int = 1            # 1 = every layer is MoE
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) configuration."""
    d_state: int = 64
    d_head: int = 64
    expand: int = 2
    chunk: int = 256
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64      # rank of the data-dependent decay LoRA
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder for enc-dec archs (whisper). Frontend is a stub: inputs are
    precomputed frame embeddings (B, enc_seq, d_model)."""
    n_layers: int = 12
    enc_seq: int = 1500


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Vision frontend stub: precomputed patch embeddings (B, n_patches, d_model)."""
    n_patches: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None     # SWA window (h2o-danube)
    mlp: str = "swiglu"                      # swiglu | gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    vlm: Optional[VLMConfig] = None
    # hybrid (zamba2): shared attention block applied every `shared_every` layers
    shared_attn_every: int = 0
    max_seq: int = 524_288
    # fused qkv / w13 column layout is interleaved in `tp_fuse` blocks so the
    # post-matmul split aligns with TP shard boundaries (no resharding
    # collectives — EXPERIMENTS.md §Perf P2). 16 = production 'model' axis;
    # archs using the 2D-TP mesh (8-way attention TP) set 8.
    tp_fuse: int = 16
    # sharding policy the launcher should pick for this arch:
    #   tp (Megatron TP+FSDP) | fsdp (pure DP, small archs) | tp2d (see mesh.py)
    preferred_policy: str = "tp"
    # gradient-accumulation microbatches for train_4k (deep models: shrinks
    # the remat-saved activation stack; §Perf G3)
    accum_steps: int = 1
    source: str = ""                         # provenance: where the config came from

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # ----- derived properties ------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm" and self.rwkv is not None or (
            self.family == "ssm" and self.ssm is not None)

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k is runnable (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        H, KV, dh = self.n_heads, self.n_kv_heads, self.d_head
        emb = V * D
        head = 0 if self.tie_embeddings else D * V
        per_layer = 0
        if self.rwkv is not None:
            # r,k,v,g,o (5 DxD) + decay lora + channel-mix (2 proj w/ F)
            per_layer = 5 * D * D + 2 * self.rwkv.decay_lora * D + D * F + F * D
        elif self.ssm is not None and self.family == "ssm":
            di = self.ssm.expand * D
            per_layer = D * (2 * di + 2 * self.ssm.d_state) + di * D + di
        else:
            attn = D * H * dh + 2 * D * KV * dh + H * dh * D
            if self.moe is not None:
                Fm = self.moe.d_ff_expert
                moe_mlp = self.moe.n_experts * (3 * D * Fm) + D * self.moe.n_experts
                n_moe = len([i for i in range(L) if i % self.moe.every == self.moe.every - 1]) \
                    if self.moe.every > 1 else L
                n_dense = L - n_moe
                per_layer = attn + (n_moe * moe_mlp + n_dense * 3 * D * F) / max(L, 1)
            else:
                k = 3 if self.mlp == "swiglu" else 2
                per_layer = attn + k * D * F
        if self.family == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * D
            per_layer = D * (2 * di + 2 * self.ssm.d_state) + di * D + di
            # one shared attention+MLP block
            shared = D * H * dh + 2 * D * KV * dh + H * dh * D + 3 * D * F
            return int(emb + head + L * per_layer + shared)
        total = emb + head + L * per_layer
        if self.encoder is not None:
            enc_layer = D * H * dh * 2 + H * dh * D * 2 + 2 * D * F  # self-attn + gelu mlp
            # decoder cross-attn adds ~1 attn block per decoder layer
            total += self.encoder.n_layers * enc_layer + L * (D * H * dh + 2 * D * KV * dh + H * dh * D)
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params()
        D, L = self.d_model, self.n_layers
        Fm = self.moe.d_ff_expert
        full = self.n_params()
        all_experts = L * self.moe.n_experts * 3 * D * Fm
        active = L * self.moe.top_k * 3 * D * Fm
        return int(full - all_experts + active)

    def canonical_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True, default=str)

    def digest(self) -> str:
        """Content address of this config — the 'Singularity image digest'."""
        return hashlib.sha256(self.canonical_json().encode()).hexdigest()[:16]

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test sized version of the same family."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.shared_attn_every == 0 else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=256,
            vocab_size=512,
            d_head=32,
            max_seq=512,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64)
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(self.ssm, d_state=16, d_head=32, chunk=64)
        if self.rwkv is not None:
            small["rwkv"] = dataclasses.replace(self.rwkv, head_size=32, decay_lora=8, chunk=32)
        if self.encoder is not None:
            small["encoder"] = dataclasses.replace(self.encoder, n_layers=2, enc_seq=64)
        if self.vlm is not None:
            small["vlm"] = dataclasses.replace(self.vlm, n_patches=16)
        if self.shared_attn_every:
            small["shared_attn_every"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and the reason if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode requires sub-quadratic attention (DESIGN.md §5)"
    return True, ""
