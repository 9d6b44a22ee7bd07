from .flash_attention import (ATTN_CHUNK, LAUNCHES, flash_attention,
                              flash_attention_plain, kernel_operand,
                              reset_launches)
from .ops import flash_attention_op

__all__ = ["ATTN_CHUNK", "LAUNCHES", "flash_attention", "flash_attention_op",
           "flash_attention_plain", "kernel_operand", "reset_launches"]
