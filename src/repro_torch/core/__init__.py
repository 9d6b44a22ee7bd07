"""The paper's contribution as a composable substrate, on PyTorch: manifests,
automated work queries, content-addressed pipelines, checksummed tiered
storage, provenance, ingest with the fused QA+checksum kernels, the workflow
engine, the campaign planner, and the cost model."""
from .integrity import (IntegrityError, fletcher64, fletcher64_file,
                        sha256_file, sha256_load_array, sha256_save_array,
                        array_checksum, verified_copy)
from .manifest import DatasetManifest, ImageRecord, synthesize_dataset
from .pipelines import Pipeline, PipelineSpec, builtin_pipelines
from .provenance import Provenance, make_provenance, is_complete
from .query import (WorkUnit, Exclusion, dump_units, load_units,
                    query_available_work, write_exclusion_csv)
from .storage import TieredStore, TIERS
from .workflow import (JobPlan, LocalRunner, StragglerDetector, UnitResult,
                       dedupe_results, generate_jobs, load_unit_inputs,
                       resource_status, run_unit, run_unit_with_retries)
from .cost import (PAPER_ENVS, job_cost, paper_table1,
                   cost_ratio_cloud_vs_hpc)
from .ingest import IngestRule, ingest_directory, write_raw_dump

__all__ = [
    "IntegrityError", "fletcher64", "fletcher64_file", "sha256_file",
    "sha256_load_array", "sha256_save_array", "array_checksum",
    "verified_copy", "DatasetManifest", "ImageRecord", "synthesize_dataset",
    "Pipeline", "PipelineSpec", "builtin_pipelines", "Provenance",
    "make_provenance", "is_complete", "WorkUnit", "Exclusion",
    "query_available_work", "write_exclusion_csv", "TieredStore", "TIERS",
    "JobPlan", "LocalRunner", "StragglerDetector", "UnitResult",
    "dedupe_results", "generate_jobs", "load_unit_inputs", "resource_status",
    "run_unit", "run_unit_with_retries",
    "PAPER_ENVS", "job_cost", "paper_table1", "cost_ratio_cloud_vs_hpc",
    "IngestRule", "ingest_directory", "write_raw_dump",
    "dump_units", "load_units",
    "CampaignPlan", "Cohort", "Shard", "admission_throttle",
    "cohort_from_query", "plan_campaign", "summaries_from_queue",
]

_CAMPAIGN_NAMES = ("CampaignPlan", "Cohort", "Shard", "admission_throttle",
                   "cohort_from_query", "plan_campaign",
                   "summaries_from_queue")


def __getattr__(name):
    # campaign is loaded lazily: it imports repro_torch.dist (for the shared
    # placement scorer + digest summaries), and repro_torch.dist.cache imports
    # repro_torch.core.integrity — an eager import here would cycle whenever
    # repro_torch.dist is imported first
    if name in _CAMPAIGN_NAMES:
        from . import campaign
        return getattr(campaign, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
