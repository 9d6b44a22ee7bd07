from .serve_step import (greedy_sample, make_decode_step, make_prefill_step,
                         shard_serve_state, zero_cache)

__all__ = ["make_prefill_step", "make_decode_step", "greedy_sample",
           "shard_serve_state", "zero_cache"]
