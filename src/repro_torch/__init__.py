"""repro_torch: the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Same data workflow as the JAX package (ingest with the fused QA+checksum
pass, BIDS manifest, automated work query, content-addressed pipelines,
provenance-gated execution), with every TPU kernel on the path rewritten
by hand in CUDA C++ for ``sm_90a``. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; there is no silent CPU fallback.
"""
from .device import resolve_device
# the port's own configs, which register themselves with ``configs``
from .configs import granite_4_0_h_small  # noqa: F401

__version__ = "1.0.0"

__all__ = ["resolve_device", "__version__"]
