"""What each gloo rank runs for ``test_torch_serve_mesh.py`` (through
``torch_ranks.run_ranks``): the port's ``serve_batch`` on a ``DeviceMesh``
(the mesh prefill and decode steps) against its own one-process
``serve_batch`` on the same params (the JAX package's, drawn by the test
and carried across by ``repro_torch.convert.from_jax``), at reduced
configs (2 layers, vocab 128, f32 compute and cache). Each function
returns plain numbers, flags and arrays; the test file asserts on them."""
import contextlib

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.dist import sharding
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.specs import state_specs
from repro_torch.models import mamba2
from torch_serve_ref import ARCHS as REF_ARCHS
from torch_serve_ref import BATCH, MESHES, prompts

CASES = ("llama3.2-1b", "zamba2-1.2b", "rwkv6-1.6b", "moonshot-v1-16b-a3b",
         "whisper-small", "internvl2-76b")
# the "long" rules on (2, 2), batch 1: (config overrides, prompt, new);
# h2o-danube's window cut to 16 so that its 24-token prompt passes it
LONG = {"h2o-danube-1.8b": (dict(sliding_window=16), 24, 9),
        "zamba2-1.2b": ({}, 20, 9), "rwkv6-1.6b": ({}, 20, 9)}


def cfg_of(arch, **kw):
    return get_config(arch).reduced(n_layers=2, vocab_size=128, **kw)


def _full(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).float() \
        .numpy()


def _shard_mismatches(tree, shardings=None, rules=None):
    """Leaves whose local tensor (``_local_tensor``) is not its spec's
    shard: another shape, placements or count of bytes. The specs are
    ``shardings``' or, for a cache, ``cache_specs``' for the leaf's
    shape under ``rules`` (``cache_leaf_spec``)."""
    bad = []
    for path, x in tree_util.flatten_with_paths(tree):
        s = tree_util.at(shardings, path) if shardings is not None else \
            sharding.NamedSharding(rules.mesh, sharding.cache_leaf_spec(
                str(path[-1]), x.shape, rules))
        want = tuple(sl.stop - sl.start for sl in s.local_slices(x.shape))
        loc = x._local_tensor
        if tuple(loc.shape) != want or tuple(x.placements) != s.placements \
                or loc.numel() * loc.element_size() != \
                int(np.prod(want)) * x.element_size():
            bad.append(tree_util.path_key(path))
    return bad


def served(cfg, params, toks, new, *, mesh=None, long=False):
    """``serve_batch`` of ``cfg`` (f32) with the logits of its prefill and
    each decode step recorded (whole, numpy) and, on a mesh, each rank's
    weight and cache bytes held to their specs (the weights'
    ``state_specs``, the prefill's and the grafted decode cache's
    ``cache_specs``): (tokens, logits, the leaves that are not their
    spec's shard)."""
    logits, bad = [], []
    real = serve_mod.make_prefill_step, serve_mod.make_decode_step
    rules = None if mesh is None else sharding.Rules(
        mesh, "long" if long else "decode", global_batch=toks.shape[0])

    def prefill_factory(cfg, *a, **kw):
        step = real[0](cfg, *a, **kw)

        def prefill(params, batch):
            out, cache = step(params, batch)
            logits.append(_full(out))
            if mesh is not None:
                bad.extend(_shard_mismatches(
                    params, state_specs(cfg, rules, torch.bfloat16)[1]))
                bad.extend(_shard_mismatches(cache, rules=rules))
            return out, cache
        return prefill

    def decode_factory(cfg, *a, **kw):
        step = real[1](cfg, *a, **kw)

        def decode(params, cache, token, pos):
            if mesh is not None and len(logits) == 1:   # the grafted cache
                bad.extend(_shard_mismatches(cache, rules=rules))
            out, cache = step(params, cache, token, pos)
            logits.append(_full(out)[:, 0])
            return out, cache
        return decode

    real_cfg = serve_mod.get_config
    serve_mod.make_prefill_step, serve_mod.make_decode_step = \
        prefill_factory, decode_factory
    serve_mod.get_config = lambda name: cfg
    try:
        out = serve_mod.serve_batch(cfg.name, toks, new, reduced=False,
                                    params=params, device="cpu", mesh=mesh,
                                    long=long, compute_dtype=torch.float32)
    finally:
        serve_mod.make_prefill_step, serve_mod.make_decode_step = real
        serve_mod.get_config = real_cfg
    return out, logits, bad


def _rel(got, want) -> float:
    return max(float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
               for g, w in zip(got, want))


def compare(cfg, params, seq, new, mesh, *, long=False, batch=BATCH):
    """The mesh run against the one-process run: (tokens equal, the
    largest relative logit error over the prefill and the decode steps,
    shard mismatches, the mesh's logits and tokens)."""
    toks = prompts(cfg.vocab_size, seq, batch)
    want_t, want, _ = served(cfg, params, toks, new)
    got_t, got, bad = served(cfg, params, toks, new, mesh=mesh, long=long)
    return {"tokens_equal": bool(np.array_equal(got_t, want_t)),
            "err": _rel(got, want), "steps": len(got), "bad": bad,
            "logits": got, "tokens": got_t}


def _params(tree):
    return from_jax(tree, "cpu")


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def group_serve(rank, world, shape, params):
    """Every case on a ``shape`` mesh; on (2, 2) also the "long" cases,
    the JAX reference's archs' logits kept, the broken controls (the
    decode combine dropped; K4 on a rank's part of Mamba-2's gated norm)
    and the norms K4 ran."""
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    seq, new = MESHES[shape]
    out = {}
    for arch in CASES:
        r = compare(cfg_of(arch), _params(params[arch]), seq, new, mesh)
        if not (shape == (2, 2) and arch in REF_ARCHS and rank == 0):
            r.pop("logits")
        out[arch] = r
    if shape != (2, 2):
        return out
    for arch, (kw, s, n) in LONG.items():
        r = compare(cfg_of(arch, **kw), _params(params[arch]), s, n, mesh,
                    long=True, batch=1)
        r.pop("logits")
        out["long", arch] = r
    llama = cfg_of("llama3.2-1b")
    with _patched(sharding, "combine", lambda x, grp, op="sum": x):
        r = compare(llama, _params(params["llama3.2-1b"]), seq, new, mesh)
    r.pop("logits")
    out["no_combine"] = r
    zamba = cfg_of("zamba2-1.2b")
    zp = _params(params["zamba2-1.2b"])
    real = mamba2.rmsnorm
    toks = prompts(zamba.vocab_size, seq)
    calls = {}
    for where, m in (("one", None), ("mesh", mesh)):
        n = [0]

        def counted(x, scale, eps=1e-5):
            n[0] += 1
            return real(x, scale, eps)
        with _patched(mamba2, "rmsnorm", counted):
            served(zamba, zp, toks, new, mesh=m)
        calls[where] = n[0]
    out["mamba_k4_calls"] = calls
    with _patched(mamba2, "_rmsnorm_split",
                  lambda x, scale, eps, d, grp: real(x, scale, eps)):
        r = compare(zamba, zp, seq, new, mesh)
    r.pop("logits")
    out["norm_on_part"] = r
    return out
