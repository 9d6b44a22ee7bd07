from .serve_step import greedy_sample, make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step", "greedy_sample"]
