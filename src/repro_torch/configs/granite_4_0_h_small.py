"""granite-4.0-h-small [hybrid_moe] — IBM Granite 4.0-H Small (32B-A9B,
``model_type`` granitemoehybrid): 40 layers, attention at indices 5, 15,
25 and 35 and Mamba-2 (128 heads of 64, d_state 128, one group) at the
rest, each mixer followed by a dropless MoE of 72 SwiGLU experts (top 10 of
the router's logits, then a softmax over them) and a shared SwiGLU expert;
GQA 32/8 heads of 128 with no position embedding at softmax scale 1/128;
the muP multipliers (embedding x12, sublayers x0.22, logits /16); tied
embeddings. [hf:ibm-granite/granite-4.0-h-small config.json]

Importing it registers the config (the port's own: the reference has no
such arch, and ``configs/__init__.py`` is the reference's copy)."""
from . import _REGISTRY
from .base import SSMConfig
from .hybrid_moe import DroplessMoEConfig, HybridMoEConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab_size=100352,
    d_head=128,
    norm_eps=1e-5,
    rope_theta=10_000.0,
    tie_embeddings=True,
    moe=DroplessMoEConfig(n_experts=72, top_k=10, d_ff_expert=768,
                          d_ff_shared=1536, router_aux_weight=0.0),
    ssm=SSMConfig(d_state=128, d_head=64, expand=2, chunk=256, d_conv=4),
    layer_types=_PERIOD * 4,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    max_seq=131_072,
    # q, k, v and the SwiGLU halves as the published checkpoint lays them
    # out (q_proj / k_proj / v_proj; input_linear's gate then up): no
    # interleaved fusion
    tp_fuse=1,
    source="hf:ibm-granite/granite-4.0-h-small",
)

_REGISTRY[CONFIG.name] = CONFIG
