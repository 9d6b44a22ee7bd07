"""Launchers of the port: ``serve`` (batched prefill + greedy decode),
``train`` (the data pipeline, the train loop and async checkpoints) and
``slurm`` (the campaign's per-shard job arrays)."""
