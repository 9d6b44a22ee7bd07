"""Launchers of the port: ``serve`` (batched prefill + greedy decode) and
``train`` (the data pipeline, the train loop and async checkpoints)."""
