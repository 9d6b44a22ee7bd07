"""Launchers of the port: ``serve`` (batched prefill + greedy decode),
``train`` (the data pipeline, the train loop and async checkpoints),
``slurm`` (the campaign's per-shard job arrays) and ``env`` (the allocator
profile that coordinator and worker processes apply)."""

__all__ = ["apply_env_profile", "env_profile", "format_exports"]


def __getattr__(name):
    # env is loaded lazily so ``python -m repro_torch.launch.env`` doesn't
    # trip runpy's found-in-sys.modules warning
    if name in ("apply_env_profile", "env_profile", "format_exports"):
        from . import env
        return getattr(env, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
