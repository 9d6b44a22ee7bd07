"""The port's one device rule: ``None`` means ``cuda``, and ``cuda`` without
a card is an error, never a quiet move to the CPU. Constructors of weights
and caches also take ``meta``: shape-only trees with no storage and no
draw, which ``launch/specs.py`` builds for configs larger than any host."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the ``torch.device`` an entry point runs on. Raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default) and
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the GPU by default; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_init_device(device: DeviceLike = None) -> torch.device:
    """:func:`resolve_device` for the constructors of weights and caches,
    which also take ``meta`` (a shape-only tree)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)
