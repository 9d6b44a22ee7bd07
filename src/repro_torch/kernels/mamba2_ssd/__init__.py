from .mamba2_ssd import (LAUNCHES, reset_launches, ssd_chunked,
                         ssd_chunked_plain)
from .ops import ssd_chunked_op
from .ref import ssd_ref

__all__ = ["LAUNCHES", "reset_launches", "ssd_chunked", "ssd_chunked_op",
           "ssd_chunked_plain", "ssd_ref"]
