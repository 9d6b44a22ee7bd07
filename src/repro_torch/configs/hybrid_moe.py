"""The hybrid_moe family's configuration (granitemoehybrid), which the
reference does not define. ``configs/base.py`` and ``configs/__init__.py``
are the reference's modules byte for byte (``tests/test_torch_core.py``),
so the family's fields live in subclasses here, and its configs add
themselves to the shared registry when imported (``repro_torch/
__init__.py`` imports them, so ``get_config`` finds them; ``ARCH_IDS``,
the reference's architectures, leaves them out)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .base import ModelConfig, MoEConfig


@dataclasses.dataclass(frozen=True)
class DroplessMoEConfig(MoEConfig):
    """The granitemoehybrid router and experts: the top ``top_k`` of the
    router's logits, a softmax over those k, every routed token computed
    (no capacity: ``capacity_factor`` is not read, nothing is dropped),
    and a shared SwiGLU expert of width ``d_ff_shared`` (0: none)."""
    d_ff_shared: int = 0


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """Each layer's mixer, "mamba" or "attention" (``layer_types``, the
    first ``n_layers`` of which run), every mixer followed by the MoE
    (``moe``, a :class:`DroplessMoEConfig`) and its shared expert; the muP
    multipliers of the family's config.json: the embedding times
    ``embedding_multiplier``, each sublayer's output times
    ``residual_multiplier`` where it joins the residual, the logits over
    ``logits_scaling``, attention's softmax scale ``attention_multiplier``
    (None: 1 / sqrt(d_head)). Attention has no position embedding (the
    family's "nope")."""
    layer_types: Tuple[str, ...] = ()
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: Optional[float] = None

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if len(self.layer_types) < self.n_layers or not set(
                self.layer_types) <= {"mamba", "attention"}:
            raise ValueError(f"layer_types must give 'mamba' or 'attention' "
                             f"for each of the {self.n_layers} layers")
        if not isinstance(self.moe, DroplessMoEConfig) or self.ssm is None:
            raise ValueError("a hybrid_moe config takes a DroplessMoEConfig "
                             "and an SSMConfig")

    def mixers(self) -> Tuple[str, ...]:
        """The mixer of each layer that runs."""
        return self.layer_types[:self.n_layers]

    def n_params(self) -> int:
        D, V, L = self.d_model, self.vocab_size, self.n_layers
        H, KV, dh = self.n_heads, self.n_kv_heads, self.d_head
        s, m = self.ssm, self.moe
        di, N = s.expand * D, s.d_state
        Hm = di // s.d_head
        mamba = D * (2 * di + 2 * N + Hm) + s.d_conv * (di + 2 * N) \
            + (di + 2 * N) + 3 * Hm + di + di * D + D
        attn = D * H * dh + 2 * D * KV * dh + H * dh * D + D
        ffn = D * m.n_experts + m.n_experts * 3 * D * m.d_ff_expert \
            + 3 * D * m.d_ff_shared + D
        mix = self.mixers()
        return int(V * D + (0 if self.tie_embeddings else D * V) + D
                   + mix.count("mamba") * mamba
                   + mix.count("attention") * attn + L * ffn)

    def n_active_params(self) -> int:
        """The routed experts' top_k of n_experts count."""
        m = self.moe
        return int(self.n_params() - self.n_layers * (m.n_experts - m.top_k)
                   * 3 * self.d_model * m.d_ff_expert)

    def reduced(self, **overrides) -> "HybridMoEConfig":
        """The common small widths, one whole period of 10 layers (the
        attention layer at index 5), 8 experts, top 3, the shared
        expert."""
        small = super().reduced()
        moe = dataclasses.replace(small.moe, n_experts=8,
                                  top_k=min(self.moe.top_k, 3),
                                  d_ff_shared=128 if self.moe.d_ff_shared
                                  else 0)
        scale = None if self.attention_multiplier is None \
            else 1.0 / small.d_head
        return dataclasses.replace(small, n_layers=min(self.n_layers, 10),
                                   moe=moe, attention_multiplier=scale,
                                   **overrides)
