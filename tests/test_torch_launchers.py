"""The port's pod launcher (``repro_torch.launch.slurm.write_pod_launch``)
against the reference's, and the variables it exports against what the
port's training launcher reads (``repro_torch.launch.train.dist_env``).

The reference's pod script exports ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, which its training launcher
never reads (ROADMAP Queue 3, R11). The port's script is the reference's
line for line with only these changes: the exports are the torchrun
variables, the module is ``repro_torch.launch.train``, the one-task-a-host
array becomes one job over the hosts with ``gpus_per_host`` tasks a host
and one GPU a task (``WORLD_SIZE`` hosts x GPUs; each task takes ``RANK``
from ``SLURM_PROCID`` and ``LOCAL_RANK`` from ``SLURM_LOCALID``), and the
worker profile is evaluated before ``srun`` (as in the shard script). The
exports run under ``bash`` here and must give the launcher the rank, local
rank, world, address and port the script names.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch.slurm import write_pod_launch as ref_write_pod_launch
from repro_torch.launch.slurm import SHARD_TEMPLATE, write_pod_launch
from repro_torch.launch.train import dist_env

SRC = Path(__file__).resolve().parents[1] / "src"
EVAL = next(ln for ln in SHARD_TEMPLATE.splitlines()
            if ln.startswith('eval "$(python -m repro_torch.launch.env'))


def _expected(ref_lines, n_hosts, gpus, host, port):
    out = []
    for ln in ref_lines:
        if ln.startswith("#SBATCH --array="):
            out += [f"#SBATCH --nodes={n_hosts}",
                    f"#SBATCH --ntasks-per-node={gpus}"]
        elif ln == "#SBATCH --nodes=1":
            out.append("#SBATCH --gpus-per-task=1")
        elif ln.startswith("#SBATCH --output="):
            out.append(ln.replace("%x_%a.out", "%x_%j.out"))
        elif ln.startswith("export JAX_COORDINATOR_ADDRESS="):
            out += [f"export MASTER_ADDR={host}", f"export MASTER_PORT={port}"]
        elif ln.startswith("export JAX_NUM_PROCESSES="):
            out.append(f"export WORLD_SIZE={n_hosts * gpus}")
        elif ln == "export JAX_PROCESS_ID=$SLURM_ARRAY_TASK_ID":
            out.append(EVAL)
        elif ln.startswith("srun python -m repro.launch.train"):
            out += ["srun bash -c 'set -euo pipefail",
                    "export RANK=$SLURM_PROCID",
                    "export LOCAL_RANK=$SLURM_LOCALID",
                    ln.replace("srun python -m repro.launch.train",
                               "exec python -m repro_torch.launch.train")]
        elif ln.endswith("--resume"):
            out.append(ln + "'")
        else:
            out.append(ln)
    return out


@pytest.mark.parametrize("kw", [
    dict(arch="llama3.2-1b"),
    dict(arch="granite-34b", n_hosts=16, coordinator="gpu-a17:29500",
         steps=500, data_dir="/scratch/shards", ckpt_dir="/scratch/ck",
         cpus=8, walltime="12:00:00", gpus_per_host=4),
], ids=["defaults", "custom"])
def test_pod_script_is_the_reference_with_named_substitutions(tmp_path, kw):
    gpus = kw.pop("gpus_per_host", None)
    ref = ref_write_pod_launch(tmp_path / "ref", **kw)
    port = write_pod_launch(tmp_path / "port", **kw, **(
        {} if gpus is None else {"gpus_per_host": gpus}))
    assert port.name == ref.name == f"train_{kw['arch']}.slurm"
    # the log directory is the only path in the scripts
    ref_lines = ref.read_text().replace(str(tmp_path / "ref"),
                                        str(tmp_path / "port")).splitlines()
    host, p = kw.get("coordinator", "pod0-host0:8476").rsplit(":", 1)
    want = _expected(ref_lines, kw.get("n_hosts", 64), gpus or 8, host, p)
    assert port.read_text().splitlines() == want
    text = port.read_text()
    n = kw.get("n_hosts", 64)
    assert f"#SBATCH --nodes={n}" in text and "--array" not in text
    assert f"#SBATCH --ntasks-per-node={gpus or 8}" in text
    assert f"--arch {kw['arch']} --full" in text and "--resume" in text
    assert "JAX_" not in text
    lines = text.splitlines()
    assert lines.index(EVAL) < next(i for i, ln in enumerate(lines)
                                    if ln.startswith("srun "))


def test_exports_under_bash_are_what_the_launcher_reads(tmp_path):
    """The script's export lines (the job's, then each task's) run under
    bash (``set -euo pipefail``, no ``|| true``) as the task SLURM numbers
    11, the fourth of its host; the launcher's env reader then gives rank
    11, local rank 3, of 64 hosts x 8 GPUs at pod0-host0:8476."""
    script = write_pod_launch(tmp_path, arch="llama3.2-1b").read_text()
    exports = [ln for ln in script.splitlines() if ln.startswith("export ")]
    assert len(exports) == 5
    body = "set -euo pipefail\n" + "\n".join(exports) + "\n" + (
        f"{sys.executable} -c 'import json; from repro_torch.launch.train "
        "import dist_env; print(json.dumps(dist_env()))'\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(SLURM_PROCID="11", SLURM_LOCALID="3", PYTHONPATH=str(SRC))
    out = subprocess.run(["bash", "-c", body], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"world": 512, "rank": 11, "local_rank": 3,
                   "addr": "pod0-host0", "port": 8476}
    # outside a task (no SLURM_PROCID) the exports fail (set -u), as on
    # SLURM
    env.pop("SLURM_PROCID")
    out = subprocess.run(["bash", "-c", body], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "SLURM_PROCID" in out.stderr


def test_dist_env_defaults_to_one_process():
    assert dist_env({}) == {"world": 1, "rank": 0, "local_rank": 0,
                            "addr": "127.0.0.1", "port": 29500}
    assert dist_env({"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1",
                     "MASTER_ADDR": "h", "MASTER_PORT": "7"}) == \
        {"world": 8, "rank": 5, "local_rank": 1, "addr": "h", "port": 7}


def test_a_cuda_launch_without_a_card_raises(monkeypatch, tmp_path):
    """``WORLD_SIZE`` > 1 without ``--device cpu`` asks for NCCL on the
    card; without one it raises before any process group, never falling
    back to gloo."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train("llama3.2-1b", steps=1, data_dir=str(tmp_path / "d"),
              ckpt_dir=str(tmp_path / "c"))
    assert not dist.is_initialized()
