"""The program's ``ModelConfig`` for a configuration file: the file's
numbers as they are run, not the program's presets."""
from __future__ import annotations

import dataclasses


def model_config(c: dict):
    from repro_torch.configs import ModelConfig, SSMConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in c.items() if k in names and k != "ssm"}
    if "ssm" in c:
        kw["ssm"] = SSMConfig(**c["ssm"])
    return ModelConfig(**kw)
