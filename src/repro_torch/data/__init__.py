from .pipeline import DataPipeline, ShardedTokenSource, make_lm_batches

__all__ = ["DataPipeline", "ShardedTokenSource", "make_lm_batches"]
