from .ops import wkv6_op
from .ref import wkv6_ref
from .rwkv6 import (LAUNCHES, reset_launches, wkv6_chunked,
                    wkv6_chunked_plain)

__all__ = ["LAUNCHES", "reset_launches", "wkv6_chunked",
           "wkv6_chunked_plain", "wkv6_op", "wkv6_ref"]
