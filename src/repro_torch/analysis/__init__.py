"""The dry-run's analysis, as the reference's ``repro/analysis``: the
analytic flop and HBM count (``flops``), the H100 roofline and MemTracker's
peak by kind (``roofline``), the collectives a traced step issues
(``comm_count``, which replaces ``hlo_parse``) and the tables
(``report``, ``python -m repro_torch.analysis``)."""
from .comm_count import CollectiveLog
from .flops import step_flops, step_hbm_bytes
from .roofline import (H100, Hardware, model_flops, rank_hbm_bytes,
                       roofline_terms, summarize_memory)

__all__ = ["CollectiveLog", "H100", "Hardware", "model_flops",
           "rank_hbm_bytes", "roofline_terms", "step_flops",
           "step_hbm_bytes", "summarize_memory"]
