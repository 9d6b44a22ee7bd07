"""Distribution layer of the port: the multi-node work-stealing executor
(``cluster`` + ``queue``) in process, its write-ahead ``journal``, the
per-host content-addressed input cache (``cache``), and the shared placement
scorer (``placement``) both the queue and the campaign planner rank
candidates with.

Not yet ported, so not exported (ROADMAP.md, Queue 1): the socket transport
``rpc`` (``QueueClient``, ``QueueServer``), the peer blob fabric
``blobserve`` (``BlobServer``, ``PeerFabric``, ``fetch_blob``), the chaos
proxy ``faults`` (``ChaosProxy``) — item 3b — and the JAX-only ``sharding``
(``Rules``, ``param_specs``, ``constrain``, ...) and ``collectives`` —
item 4. ``run_worker`` is exported and raises ``NotImplementedError`` until
``rpc`` exists."""
from .cache import (DigestSummary, InputCache, cache_from_env,
                    harvest_summary, load_summary_file, save_summary_file,
                    summaries_from_cache_dirs)
from .cluster import ClusterRunner, ClusterStats, Node, run_worker
from .placement import WarmSetIndex, best_node, best_peers, unit_local_bytes
from .queue import Lease, WorkQueue

__all__ = [
    "ClusterRunner", "ClusterStats", "Node", "Lease", "WorkQueue",
    "DigestSummary", "InputCache", "cache_from_env", "Journal",
    "JournalCorrupt", "run_worker",
    "WarmSetIndex", "best_node", "best_peers", "unit_local_bytes",
    "harvest_summary", "load_summary_file", "save_summary_file",
    "summaries_from_cache_dirs",
]


def __getattr__(name):
    # journal is loaded lazily so `python -m repro_torch.dist.journal` (the
    # CLI) doesn't trip runpy's found-in-sys.modules warning
    if name in ("Journal", "JournalCorrupt"):
        from . import journal
        return getattr(journal, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
