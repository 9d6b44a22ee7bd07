"""Launchers of the port: ``serve`` (batched prefill + greedy decode),
``train`` (the data pipeline, the train loop and async checkpoints, on one
device or a ``DeviceMesh``), ``mesh`` (the reference's production, tp2d
and local meshes, and a placeholder mesh over a fake process group),
``specs`` (shape-only inputs and their shardings for every cell),
``dryrun`` (every cell traced under fake tensors on a placeholder mesh:
flops, peak memory and collectives a rank, ``python -m
repro_torch.launch.dryrun``),
``slurm`` (the multi-host training arrays and the campaign's per-shard job
arrays) and ``env`` (the allocator profile that coordinator and worker
processes apply)."""

__all__ = ["apply_env_profile", "env_profile", "format_exports",
           "lower_cell", "make_local_mesh", "make_production_mesh",
           "make_tp2d_mesh", "placeholder_mesh", "run_cell"]

_MESH = ("make_local_mesh", "make_production_mesh", "make_tp2d_mesh",
         "placeholder_mesh")


def __getattr__(name):
    # env and dryrun are loaded lazily so ``python -m
    # repro_torch.launch.env`` (or ``.dryrun``) doesn't trip runpy's
    # found-in-sys.modules warning
    if name in ("apply_env_profile", "env_profile", "format_exports"):
        from . import env
        return getattr(env, name)
    if name in ("lower_cell", "run_cell"):
        from . import dryrun
        return getattr(dryrun, name)
    if name in _MESH:
        from . import mesh
        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
