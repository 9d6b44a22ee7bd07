"""SLURM launch scripts of the port: multi-host training arrays
(``write_pod_launch``) and the per-shard campaign arrays the
admission-time planner emits (``core/workflow.generate_jobs`` in campaign
mode).

A pod script is one job over ``n_hosts`` hosts with one task a GPU
(``gpus_per_host`` tasks a host): it exports the variables
``repro_torch.launch.train`` reads (``MASTER_ADDR`` and ``MASTER_PORT``
from the coordinator, ``WORLD_SIZE`` = hosts x GPUs a host, and in each
task ``RANK`` from ``SLURM_PROCID`` and ``LOCAL_RANK`` from
``SLURM_LOCALID``), so every GPU of every host joins one NCCL process
group and trains on one mesh. The reference's pod script exports ``JAX_*`` variables
that its training launcher never reads (ROADMAP Queue 3, R11). A shard
script's task runs ``python -m repro_torch.core.workflow --run-one``. Both
first eval ``repro_torch.launch.env``'s worker profile (the allocator
settings) on the compute node. The shard template stays byte-equal to the
reference's apart from the package name, its XLA comment included, so one
runbook reads both.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

POD_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --nodes={n_hosts}
#SBATCH --ntasks-per-node={gpus_per_host}
#SBATCH --gpus-per-task=1
#SBATCH --cpus-per-task={cpus}
#SBATCH --time={walltime}
#SBATCH --output={log_dir}/%x_%j.out
set -euo pipefail

export MASTER_ADDR={coordinator_host}
export MASTER_PORT={coordinator_port}
export WORLD_SIZE={world}
eval "$(python -m repro_torch.launch.env --role worker 2>/dev/null || true)"

srun bash -c 'set -euo pipefail
export RANK=$SLURM_PROCID
export LOCAL_RANK=$SLURM_LOCALID
exec python -m repro_torch.launch.train \\
    --arch {arch} --full --steps {steps} \\
    --data-dir {data_dir} --ckpt-dir {ckpt_dir} --resume'
"""


# One campaign shard = one job array pinned (when the plan could place it)
# to the host already holding the shard's input bytes — brainlife.io-style
# job-to-data routing at the batch-system layer. The cold shard (no warm
# host anywhere) stays untargeted so SLURM places it wherever there is room.
SHARD_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --array=0-{last_idx}%{throttle}
#SBATCH --cpus-per-task={cpus}
#SBATCH --mem={mem_gb}G
#SBATCH --time={walltime}
#SBATCH --output={log_dir}/%x_%a.out
{placement_line}

set -euo pipefail
# allocator and XLA hygiene, resolved on the *compute* node (tcmalloc
# paths differ per host; LD_PRELOAD must be set before python starts) —
# fail-soft when the package is not importable there
eval "$(python -m repro_torch.launch.env --role worker 2>/dev/null || true)"
MANIFEST={manifest_json}
python -m repro_torch.core.workflow --run-one {units_json} --index $SLURM_ARRAY_TASK_ID \\
    --data-root {data_root} --scratch $SLURM_TMPDIR
"""


def write_shard_script(out_dir: Path, *, name: str, n_units: int,
                       units_json: str, manifest_json: str, data_root: str,
                       node_id: Optional[str] = None, throttle: int = 100,
                       cpus: int = 4, mem_gb: int = 16,
                       walltime: str = "24:00:00") -> Path:
    """Write one campaign shard's SLURM array script. ``node_id`` pins the
    array to the host whose cache already holds the shard's bytes; ``None``
    (the cold shard) leaves placement to the scheduler."""
    if n_units < 1:
        raise ValueError("a shard script needs at least one unit")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    log_dir = out_dir / "logs"
    log_dir.mkdir(exist_ok=True)
    placement = (f"#SBATCH --nodelist={node_id}" if node_id
                 else "# cold shard: no warm host for these units; "
                      "scheduler places freely")
    script = SHARD_TEMPLATE.format(
        name=name, last_idx=n_units - 1, throttle=throttle, cpus=cpus,
        mem_gb=mem_gb, walltime=walltime, log_dir=str(log_dir),
        placement_line=placement, manifest_json=manifest_json,
        units_json=units_json, data_root=data_root)
    p = out_dir / f"{name}.slurm"
    p.write_text(script)
    return p


def write_pod_launch(out_dir: Path, *, arch: str, n_hosts: int = 64,
                     gpus_per_host: int = 8,
                     coordinator: str = "pod0-host0:8476", steps: int = 10000,
                     data_dir: str = "/data/shards", ckpt_dir: str = "/ckpt",
                     cpus: int = 16, walltime: str = "48:00:00") -> Path:
    """Write the training job of ``n_hosts`` hosts, ``gpus_per_host``
    tasks a host and one GPU a task, that rendezvous at ``coordinator``
    (``host:port``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    host, port = coordinator.rsplit(":", 1)
    script = POD_TEMPLATE.format(
        name=f"train_{arch}", n_hosts=n_hosts, gpus_per_host=gpus_per_host,
        world=n_hosts * gpus_per_host, coordinator_host=host,
        coordinator_port=port, arch=arch, steps=steps, data_dir=data_dir,
        ckpt_dir=ckpt_dir, cpus=cpus, walltime=walltime,
        log_dir=str(out_dir / "logs"))
    p = out_dir / f"train_{arch}.slurm"
    p.write_text(script)
    return p
