"""What each gloo rank runs for ``test_torch_obs.py`` (through
``torch_ranks.run_ranks``): the hybrid's mesh prefill step on a (1, 2)
mesh, once with the spans off and once with ``obs.enable()``; returns
whether the logits came out bit-equal and the spans' names and parents."""
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.models import init_params
from repro_torch.serve import make_prefill_step, shard_serve_state


def mesh_prefill_spans(rank, world):
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    cfg = get_config("zamba2-1.2b").reduced(n_layers=2, vocab_size=128)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, device="cpu")
    rules = sharding.Rules(mesh, "prefill", global_batch=2)
    sp = shard_serve_state(params, mesh, rules, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    step = make_prefill_step(cfg, torch.float32, mesh=mesh)
    with torch.inference_mode():
        off = step(sp, {"tokens": toks})[0].full_tensor()
        obs.enable()
        on = step(sp, {"tokens": toks})[0].full_tensor()
        obs.disable()
    recs = obs.take()
    return {"equal": torch.equal(off, on),
            "spans": [(r.name, r.parent) for r in recs],
            "every": cfg.shared_attn_every, "n_layers": cfg.n_layers}
