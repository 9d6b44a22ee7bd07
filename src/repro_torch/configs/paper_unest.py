"""paper-unest — the paper's own workload family: a UNesT-like hierarchical
transformer used by the brain-segmentation pipeline (Yu et al. 2023, cited by the
paper as one of its 16 processing pipelines). Modeled as a compact dense
transformer backbone used by ``core/pipelines.py:SegmentationPipeline``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paper-unest",
    family="dense",
    n_layers=12,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=4096,          # voxel-patch codebook
    d_head=64,
    mlp="gelu",
    source="arXiv:2209.14378 (UNesT); paper §2.1",
)
