from .mamba2_glue import (LAUNCHES, mamba2_conv_in, mamba2_conv_in_plain,
                          mamba2_gate_norm, mamba2_gate_norm_plain,
                          reset_launches, takes)

__all__ = ["LAUNCHES", "mamba2_conv_in", "mamba2_conv_in_plain",
           "mamba2_gate_norm", "mamba2_gate_norm_plain", "reset_launches",
           "takes"]
