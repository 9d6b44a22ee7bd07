"""Distribution layer of the port: the multi-node work-stealing executor
(``cluster`` + ``queue``), its socket transport (``rpc``), its write-ahead
``journal``, the per-host content-addressed input cache (``cache``), the
peer-to-peer blob fabric that serves those caches between hosts
(``blobserve``), the fault-injection proxy of the chaos tests (``faults``),
the shared placement scorer (``placement``) both the queue and the
campaign planner rank candidates with, the sharding rules and parameter
placement on a ``DeviceMesh`` (``sharding``), and the int8 compressed
gradient sum with error feedback (``collectives``)."""
from .blobserve import BlobServer, PeerFabric, fetch_blob
from .cache import (DigestSummary, InputCache, cache_from_env,
                    harvest_summary, load_summary_file, save_summary_file,
                    summaries_from_cache_dirs)
from .cluster import ClusterRunner, ClusterStats, Node, run_worker
from .placement import WarmSetIndex, best_node, best_peers, unit_local_bytes
from .queue import Lease, WorkQueue

__all__ = [
    "ClusterRunner", "ClusterStats", "Node", "Lease", "WorkQueue",
    "DigestSummary", "InputCache", "cache_from_env", "QueueClient",
    "QueueServer", "Journal", "JournalCorrupt", "ChaosProxy",
    "BlobServer", "PeerFabric", "fetch_blob", "run_worker",
    "WarmSetIndex", "best_node", "best_peers", "unit_local_bytes",
    "harvest_summary", "load_summary_file", "save_summary_file",
    "summaries_from_cache_dirs",
    "MODEL_AXES", "MeshShape", "NamedSharding", "P", "Rules",
    "attn_shard_choice", "batch_mean", "constrain",
    "constrain_params_gathered", "constrain_residual", "current_rules",
    "distribute", "param_spec_for", "param_specs", "placements_for",
    "shardings_for", "tp_size", "use_rules",
    "compressed_psum", "compressed_tree_psum", "dequantize_int8",
    "quantize_int8", "zeros_like_errors",
]

_SHARDING = ("MODEL_AXES", "MeshShape", "NamedSharding", "P", "Rules",
             "attn_shard_choice", "batch_mean", "constrain",
             "constrain_params_gathered", "constrain_residual",
             "current_rules", "distribute", "param_spec_for", "param_specs",
             "placements_for", "shardings_for", "tp_size", "use_rules")
_COLLECTIVES = ("compressed_psum", "compressed_tree_psum", "dequantize_int8",
                "quantize_int8", "zeros_like_errors")


def __getattr__(name):
    # rpc/journal are loaded lazily so `python -m repro_torch.dist.rpc` and
    # `python -m repro_torch.dist.journal` (the CLIs) don't trip runpy's
    # found-in-sys.modules warning
    if name in ("QueueClient", "QueueServer"):
        from . import rpc
        return getattr(rpc, name)
    if name in ("Journal", "JournalCorrupt"):
        from . import journal
        return getattr(journal, name)
    if name == "ChaosProxy":
        from .faults import ChaosProxy
        return ChaosProxy
    # sharding/collectives load torch.distributed only when asked for
    if name in _SHARDING:
        from . import sharding
        return getattr(sharding, name)
    if name in _COLLECTIVES:
        from . import collectives
        return getattr(collectives, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
