"""The port's sharding rules, placements and shape-only specs
(``repro_torch.dist.sharding``, ``repro_torch.launch.mesh``,
``repro_torch.launch.specs``) against the JAX package's, on the CPU.

Spec math reads only axis names and sizes, so both packages take
shape-only meshes here: the reference's ``FakeMesh`` (as its own
``tests/test_sharding.py``) and the port's ``MeshShape``, at the production
shapes (2, 16, 16) pod/data/model, (16, 16) data/model and the tp2d
(16, 8, 2). The specs of ``launch/specs.py`` need the reference's real
``NamedSharding``s: ``torch_sharding_ref.py`` computes them in a fresh
interpreter with 256 XLA CPU devices, for every runnable (arch x shape)
cell as the reference's dry-run calls them, and also each device's slice
(``devices_indices_map``) for the placement cases, which the port's
DTensor placements must give each rank of a 4-rank placeholder mesh.
Every comparison is exact: specs, shapes, dtypes and slices.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_sharding
from repro.models import init_params as ref_init_params
from repro_torch import tree as tree_util
from repro_torch.configs import (ARCH_IDS, SHAPE_BY_NAME, SHAPES,
                                 cell_is_runnable, get_config)
from repro_torch.dist.sharding import (MeshShape, NamedSharding, P, Rules,
                                       attn_shard_choice, constrain,
                                       constrain_params_gathered,
                                       param_spec_for, param_specs,
                                       placements_for, shardings_for,
                                       use_rules)
from repro_torch.launch import specs as port_specs
from repro_torch.models import init_params
from torch_sharding_ref import PLACEMENTS

HERE = Path(__file__).resolve().parent
MESHES = {"pod": ((2, 16, 16), ("pod", "data", "model")),
          "prod": ((16, 16), ("data", "model")),
          "tp2d": ((16, 8, 2), ("data", "model", "model2"))}


class FakeMesh:
    """The reference test's shape-only mesh."""
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.zeros(shape)


def _meshes(name):
    shape, axes = MESHES[name]
    return FakeMesh(shape, axes), MeshShape(shape, axes)


_REF_PARAMS = {}


def _ref_params(arch):
    if arch not in _REF_PARAMS:
        cfg = ref_get_config(arch)
        _REF_PARAMS[arch] = jax.eval_shape(
            lambda: ref_init_params(cfg, jax.random.PRNGKey(0)))
    return _REF_PARAMS[arch]


def _ref_flat(tree, is_leaf=None):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


def _port_flat(tree, prefix=()):
    """{path: leaf} of a port tree whose leaves may be specs (tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, prefix + (k,)))
        return out
    return {"/".join(map(str, prefix)): tree}


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    ref_params = _ref_params(arch)
    want = {k: tuple(s) for k, s in _ref_flat(
        ref_sharding.param_specs(ref_params, ref_mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)).items()}
    params = init_params(get_config(arch), None, torch.float32, "meta")
    got = _port_flat(param_specs(params, port_mesh))
    assert got == want
    # the meta tree is the reference's eval_shape tree, leaf for leaf
    assert {k: (tuple(v.shape), _dtype(v)) for k, v in
            _port_flat(params).items()} == \
        {k: (tuple(v.shape), str(v.dtype))
         for k, v in _ref_flat(ref_params).items()}
    assert [tree_util.path_key(p) for p, _ in
            tree_util.flatten_with_paths(params)] == list(_ref_flat(ref_params))


NAME_SETS = [("batch", None), ("batch", None, None), ("batch", "res_seq", None),
             (None, "batch", "cache_seq", None), (None, "batch", "act_model"),
             ("embed", "vocab"), ("batch", "vocab"), ("act_model",), ()]


@pytest.mark.parametrize("global_batch", [None, 256, 3], ids=str)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "long"])
def test_rules_equal_reference(kind, mesh, global_batch):
    ref_mesh, port_mesh = _meshes(mesh)
    ref = ref_sharding.Rules(ref_mesh, kind, global_batch=global_batch)
    port = Rules(port_mesh, kind, global_batch=global_batch)
    assert port.map == ref.map
    for names in NAME_SETS:
        assert port.spec(*names) == tuple(ref.spec(*names)), names
        assert isinstance(port.spec(*names), P)


@pytest.mark.parametrize("tp", [1, 2, 8, 16])
def test_attn_shard_choice_equal_reference(tp):
    shape, axes = (256 // tp, tp), ("data", "model")
    grid = [(kv, g, q) for kv in (1, 2, 4, 5, 8, 16) for g in
            (1, 2, 3, 4, 5, 8) for q in (1, 7, 16, 32, 4096)]
    with ref_sharding.use_rules(ref_sharding.Rules(FakeMesh(shape, axes))):
        want = [ref_sharding.attn_shard_choice(*c) for c in grid]
        assert ref_sharding.tp_size() == tp
    assert attn_shard_choice(8, 1, 16) is None       # no rules: tp 1
    with use_rules(Rules(MeshShape(shape, axes))):
        got = [attn_shard_choice(*c) for c in grid]
    assert got == want
    assert len(set(want)) > 1 or tp == 1          # the grid reaches choices


def test_param_rules_hit_expected_axes():
    """The reference test's ``param_spec_for`` cases."""
    mesh = MeshShape((16, 16), ("data", "model"))
    spec = param_spec_for("layers/attn/wqkv", 3, True, (16, 2048, 3072),
                          mesh)
    assert spec == P(None, "data", "model")
    assert param_spec_for("embed/tok", 2, False, (4096, 128), mesh) == \
        P("model", "data")
    # whisper vocab not divisible by 16 -> axis dropped
    assert param_spec_for("embed/tok", 2, False, (51865, 768), mesh) == \
        P(None, "data")
    # norms replicated
    assert param_spec_for("layers/ln1", 2, True) == P(None, None)
    assert P("a", None) == ("a", None) and repr(P()) == "P()"


def test_constraints_are_the_identity_without_rules():
    x = torch.ones(4, 4)
    tree = {"w": x}
    assert constrain(x, "batch", None) is x
    assert constrain_params_gathered(tree) is tree
    with use_rules(Rules(MeshShape((2, 2), ("data", "model")))):
        assert constrain(x, "batch", None) is x      # a plain tensor


def test_placements_order_and_refusals():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshShape((2, 4, 2), ("pod", "data", "model"))
    assert placements_for(P(("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements_for(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        placements_for(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="lacks"):
        placements_for(P("model2"), mesh)
    with pytest.raises(ValueError, match="twice"):
        placements_for(P("data", "data"), mesh)
    sh = shardings_for(mesh, {"a": P("data"), "b": {"c": P()}})
    assert isinstance(sh["b"]["c"], NamedSharding)
    m, pl = sh["a"]
    assert m is mesh and pl == (Replicate(), Shard(0), Replicate())


# ---------------------------------------------------------------------------
# against the reference's real NamedShardings (a fresh interpreter)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_dump(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    src = str(HERE.parent / "src")
    env = {**os.environ, "PYTHONPATH": src, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(HERE / "torch_sharding_ref.py"),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return pickle.loads(out.read_bytes())


def _rules_kind(shape) -> str:
    if shape.kind == "train":
        return "train"
    if shape.name.startswith("long"):
        return "long"
    return shape.kind


CELLS = [(a, s.name) for a in ARCH_IDS for s in SHAPES
         if cell_is_runnable(get_config(a), s)[0]]


def _structs(tree):
    return {k: (tuple(v.shape), _dtype(v)) for k, v in
            _port_flat(tree).items()}


def _specs(tree):
    return {k: tuple(s.spec) for k, s in _port_flat(tree).items()}


def test_thirty_three_runnable_cells():
    assert len(CELLS) == 33


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_launch_specs_equal_reference(ref_dump, arch, shape_name):
    want = ref_dump["cells"][arch, shape_name]
    cfg, shape = get_config(arch), SHAPE_BY_NAME[shape_name]
    mesh = MeshShape((16, 16), ("data", "model"))
    rules = Rules(mesh, _rules_kind(shape), "tp",
                  global_batch=shape.global_batch)
    dtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    params, pshard, opt, oshard = port_specs.state_specs(cfg, rules, dtype)
    for t in tree_util.leaves({"p": params, "o": opt}):
        assert t.device.type == "meta"
    got = {"params": _structs(params), "pshard": _specs(pshard),
           "opt": _structs(opt), "oshard": _specs(oshard)}
    if shape.kind in ("train", "prefill"):
        batch, bshard = port_specs.batch_specs(cfg, shape, rules, shape.kind)
        got["batch"], got["bshard"] = _structs(batch), _specs(bshard)
    if shape.kind != "train":
        cache, cshard = port_specs.cache_specs(cfg, shape, rules)
        got["cache"], got["cshard"] = _structs(cache), _specs(cshard)
    if shape.kind == "decode":
        (tok, tsh), (pos, psh) = port_specs.decode_inputs(cfg, shape, rules)
        got["decode"] = ({"": (tuple(tok.shape), _dtype(tok))},
                         tuple(tsh.spec), {"": ((), _dtype(pos))},
                         tuple(psh.spec))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k


def test_state_specs_of_the_largest_config_are_quick():
    """internvl2-76b's f32 state (~300 GB) described with no storage and
    no draw, well under a second."""
    cfg = get_config("internvl2-76b")
    rules = Rules(MeshShape((16, 16), ("data", "model")), "train")
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        params, _, opt, _ = port_specs.state_specs(cfg, rules)
        best = min(best, time.perf_counter() - t0)
    assert best < 1.0
    n = sum(t.numel() for t in tree_util.leaves(params))
    assert n > 60e9 and all(t.device.type == "meta"
                            for t in tree_util.leaves(opt))


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_placements_give_each_rank_the_reference_slice(ref_dump, fake_group):
    """Each rank of a 4-rank placeholder mesh keeps the slice that
    ``devices_indices_map`` gives the device at its mesh position, tuple
    (pod-major) entries included; ``distribute`` builds its DTensor from
    that slice."""
    from repro_torch.dist.sharding import distribute
    from repro_torch.launch.mesh import placeholder_mesh
    for (axes, entries, shape), want in zip(PLACEMENTS, ref_dump["slices"]):
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        for rank in range(4):
            mesh = placeholder_mesh((2, 2), axes, rank=rank)
            s = NamedSharding(mesh, P(*entries))
            got = tuple((sl.start, sl.stop) for sl in s.local_slices(shape))
            assert got == want[rank], (axes, entries, rank)
            dt = distribute(full, s)
            assert tuple(dt.shape) == shape
            assert torch.equal(dt.to_local(), full[s.local_slices(shape)])


def test_placeholder_mesh_builds_the_production_shapes(fake_group):
    from repro_torch.launch.mesh import (make_local_mesh,
                                         make_production_mesh,
                                         make_tp2d_mesh, placeholder_mesh)
    mesh = placeholder_mesh((2, 16, 16), ("pod", "data", "model"))
    assert tuple(mesh.shape) == (2, 16, 16)
    assert make_production_mesh(multi_pod=True).mesh_dim_names == \
        ("pod", "data", "model")
    assert tuple(make_tp2d_mesh(multi_pod=True).shape) == (2, 16, 8, 2)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    placeholder_mesh((16, 16), ("data", "model"))
    assert tuple(make_production_mesh().shape) == (16, 16)
    assert tuple(make_local_mesh().shape) == (1, 256)
    rules = Rules(make_production_mesh(), "train", global_batch=256)
    assert rules.spec("batch", None) == P("data", None)


@pytest.mark.parametrize("world,want", [
    (8, ((8, 1), ("data", "model"))),
    (256, ((16, 16), ("data", "model"))),
    (512, ((2, 16, 16), ("pod", "data", "model")))], ids=str)
def test_launcher_mesh_by_world_size(fake_group, world, want):
    """The training launcher's mesh: the production meshes at 256 and 512
    ranks, else every rank on 'data' (data parallelism), never a (1, N)
    mesh whose ranks would repeat one another's compute."""
    from repro_torch.launch.mesh import placeholder_mesh
    from repro_torch.launch.train import default_mesh
    placeholder_mesh((world,), ("all",))
    mesh = default_mesh()
    assert (tuple(mesh.shape), mesh.mesh_dim_names) == want
