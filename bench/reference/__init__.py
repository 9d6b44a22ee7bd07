"""Plain PyTorch references, one per model family: float32, no kernel,
cache or batching of the program, and nothing imported from it."""
