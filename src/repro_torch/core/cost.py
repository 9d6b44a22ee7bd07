"""Cost model (paper §2.4, Table 1) — HPC vs cloud vs local economics,
extended to GPU training economics (the reference's TPU-pod tail,
``repro/core/cost.py:67-93``, on H100 cards).

Paper constants are encoded verbatim so ``benchmarks/table1_cost.py``
reproduces the published table; ``job_cost`` generalizes to any workload.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..analysis.roofline import H100


@dataclasses.dataclass(frozen=True)
class ComputeEnv:
    name: str
    cost_per_hour: float             # one 16 GB instance (paper Table 1)
    throughput_gbps: float           # storage -> compute
    latency_ms: float
    freesurfer_minutes: float        # measured per-image pipeline time


# Paper Table 1, verbatim
PAPER_ENVS: Dict[str, ComputeEnv] = {
    "hpc": ComputeEnv("HPC (ACCRE)", 0.0096, 0.60, 0.16, 375.5),
    "cloud": ComputeEnv("Cloud (AWS t2.xlarge)", 0.1856, 0.33, 19.56, 355.2),
    "local": ComputeEnv("Local", 0.0913, 0.81, 1.64, 386.0),
}

# storage pricing (paper §2.2)
ACCRE_STORAGE_PER_TB_YEAR = 180.0
GLACIER_PER_GB_MONTH = 0.0036
SELF_HOSTED_407TB_COST = 72000.0 / 4      # amortized estimate vs ACCRE's $72k/400TB


def job_cost(env: ComputeEnv, n_jobs: int, minutes_per_job: float,
             gb_transferred_per_job: float = 1.0) -> Dict[str, float]:
    """End-to-end cost/time for a batch of pipeline jobs in one environment."""
    transfer_s = gb_transferred_per_job * 8 / env.throughput_gbps \
        + env.latency_ms / 1e3
    hours = n_jobs * (minutes_per_job * 60 + transfer_s) / 3600
    return {
        "compute_hours": hours,
        "transfer_seconds_total": n_jobs * transfer_s,
        "dollars": hours * env.cost_per_hour,
    }


def paper_table1(n_jobs: int = 6) -> Dict[str, Dict[str, float]]:
    """Reproduce Table 1's bottom row: total overhead cost to run the
    6-scan FreeSurfer experiment in each environment."""
    out = {}
    for key, env in PAPER_ENVS.items():
        c = job_cost(env, n_jobs, env.freesurfer_minutes)
        out[key] = {
            "cost_per_hr": env.cost_per_hour,
            "throughput_gbps": env.throughput_gbps,
            "latency_ms": env.latency_ms,
            "minutes_per_image": env.freesurfer_minutes,
            "total_cost": round(c["dollars"], 2),
        }
    return out


def cost_ratio_cloud_vs_hpc(n_jobs: int = 6) -> float:
    t = paper_table1(n_jobs)
    return t["cloud"]["total_cost"] / t["hpc"]["total_cost"]


# ---------------------------------------------------------------------------
# GPU extension: the paper's analysis for training on H100 cards
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GpuEnv:
    """A pool of ``gpus`` cards. The price of a card-hour is the caller's
    (no price is assumed; None gives no dollars); the peak is the
    roofline's H100 row, dense bf16."""
    name: str
    gpus: int
    cost_per_gpu_hour: Optional[float]
    peak_flops: float = H100.peak_flops


def training_run_cost(env: GpuEnv, total_model_flops: float, mfu: float
                      ) -> Dict[str, Optional[float]]:
    """Wall hours, card-hours and dollars to land a training run of
    ``total_model_flops`` at model-FLOPs utilisation ``mfu``: the
    reference's formula, with cards for chips."""
    seconds = total_model_flops / (env.gpus * env.peak_flops * mfu)
    hours = seconds / 3600
    gpu_hours = hours * env.gpus
    return {"hours": hours, "gpu_hours": gpu_hours,
            "dollars": None if env.cost_per_gpu_hour is None
            else gpu_hours * env.cost_per_gpu_hour}
