"""The port's spans and counters (``repro_torch.obs``): off, a span is one
shared object that records nothing and opens no record function; on
(``enable()`` or a running profiler) spans nest, carry their root's step
and are handed over once; the profiler keeps them on its host timeline
outside the user scope it mirrors onto the device; the kernel packages'
``LAUNCHES`` are views of one registry; and the hybrid prefill records its
layer spans without changing a bit of its output."""
import pytest
import torch

from repro_torch import obs

USER_SCOPE = 7          # at::RecordScope::USER_SCOPE, what the profiler mirrors


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.take()
    yield
    obs.disable()
    obs.take()


def test_off_span_is_one_shared_object_and_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a record function opened for {name}")
    monkeypatch.setattr(obs, "_RecordFunctionFast", refuse)
    assert not obs.enabled()
    a, b = obs.span("mamba2.layer"), obs.span("shared.block",
                                              torch.zeros(2))
    assert a is b
    with a:
        with b:
            pass
    assert obs.take() == []


def test_enable_records_nesting_parents_and_steps():
    obs.enable()
    assert obs.enabled()
    for _ in range(2):
        with obs.span("serve.prefill_step"):
            with obs.span("mamba2.layer"):
                with obs.span("mamba2.in_proj"):
                    pass
                with obs.span("mamba2.scan"):
                    pass
            with obs.span("shared.block"):
                pass
    obs.disable()
    with obs.span("mamba2.layer"):
        pass
    recs = obs.take()
    assert [r.name for r in recs] == 2 * [
        "serve.prefill_step", "mamba2.layer", "mamba2.in_proj",
        "mamba2.scan", "shared.block"]
    assert [r.parent for r in recs] == [None, 0, 1, 1, 0,
                                        None, 5, 6, 6, 5]
    assert len({r.step for r in recs[:5]}) == len({r.step for r in
                                                    recs[5:]}) == 1
    assert recs[0].step != recs[5].step
    for r in recs:
        assert r.t0_ns <= r.t1_ns and r.device_us is None
        if r.parent is not None:
            p = recs[r.parent]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns
    assert obs.take() == []


def test_a_running_profiler_turns_spans_on_and_stop_turns_them_off():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert obs.enabled()
        with obs.span("serve.prefill_step"):
            with obs.span("mamba2.layer"):
                torch.ones(4).add_(1)
    finally:
        prof.stop()
    assert not obs.enabled()
    assert obs.span("mamba2.layer") is obs.span("shared.block")
    assert [(r.name, r.parent) for r in obs.take()] == [
        ("serve.prefill_step", None), ("mamba2.layer", 0)]
    evs = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("serve.prefill_step", "mamba2.layer"):
        assert str(evs[name].device_type()).endswith("CPU")
        assert evs[name].scope() != USER_SCOPE
        assert not evs[name].is_user_annotation()
    outer, inner = evs["serve.prefill_step"], evs["mamba2.layer"]
    assert outer.start_ns() <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= \
        outer.start_ns() + outer.duration_ns()


def test_self_times_subtract_the_children():
    R = obs.SpanRecord
    recs = [R("serve.prefill_step", None, 1, 0, 9, 100.0),
            R("mamba2.layer", 0, 1, 1, 5, 60.0),
            R("mamba2.in_proj", 1, 1, 1, 2, 10.0),
            R("mamba2.scan", 1, 1, 2, 3, 20.0),
            R("shared.block", 0, 1, 6, 8, 30.0),
            R("mamba2.layer", None, 2, 10, 11, None)]
    assert obs.self_us(recs) == [10.0, 30.0, 10.0, 20.0, 30.0, None]


def test_counters_are_views_of_one_registry():
    a = obs.Counters("test_obs", "x", "y")
    b = obs.Counters("test_obs_other", "x")
    a.add("x")
    a.add("y", 3)
    b.add("x", 5)
    assert dict(a) == {"x": 1, "y": 3} and a == {"x": 1, "y": 3}
    assert obs.COUNTS["test_obs.y"] == 3 and obs.COUNTS["test_obs_other.x"] \
        == 5
    assert len(a) == 2 and list(a) == ["x", "y"]
    with pytest.raises(KeyError):
        a["z"]
    a.reset()
    assert dict(a) == {"x": 0, "y": 0} and b["x"] == 5
    for k in ("test_obs.x", "test_obs.y", "test_obs_other.x"):
        del obs.COUNTS[k]


PACKAGES = {"checksum": ("qa_checksum", "qa_checksum_chunk",
                         "device_checksum"),
            "rmsnorm": ("rmsnorm",), "flash_attention": ("flash_attention",),
            "mamba2_ssd": ("ssd_chunked",), "rwkv6": ("wkv6_chunked",)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_kernel_launches_are_registry_views_reset_one_package(pkg):
    import importlib
    mods = {p: importlib.import_module(f"repro_torch.kernels.{p}")
            for p in PACKAGES}
    mod = mods[pkg]
    assert tuple(mod.LAUNCHES) == PACKAGES[pkg]
    for p, m in mods.items():
        m.LAUNCHES.add(PACKAGES[p][0], 2)
    before = dict(mod.LAUNCHES)
    assert mod.LAUNCHES == before                  # as a dict compares
    assert obs.COUNTS[f"launches.{PACKAGES[pkg][0]}"] == \
        mod.LAUNCHES[PACKAGES[pkg][0]] >= 2
    mod.reset_launches()
    assert all(v == 0 for v in mod.LAUNCHES.values())
    for p, m in mods.items():
        if p != pkg:
            assert m.LAUNCHES[PACKAGES[p][0]] >= 2
        m.reset_launches()


def _tiny_hybrid():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("zamba2-1.2b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.bfloat16, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 2 * cfg.ssm.chunk + 9),
                         generator=torch.Generator().manual_seed(1))
    return cfg, params, {"tokens": toks}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_prefill_spans_leave_the_output_bit_equal_and_nest_by_layer():
    from repro_torch.serve import make_prefill_step
    cfg, params, batch = _tiny_hybrid()
    step = make_prefill_step(cfg, torch.bfloat16)
    with torch.inference_mode():
        off = step(params, batch)
        assert obs.take() == []
        obs.enable()
        on = step(params, batch)
        obs.disable()
    for a, b in zip(_leaves(dict(enumerate(off))),
                    _leaves(dict(enumerate(on)))):
        assert torch.equal(a, b)
    recs = obs.take()
    assert [r.name for r in recs].count("serve.prefill_step") == 1
    root = recs[0]
    assert root.name == "serve.prefill_step" and root.parent is None
    assert {r.step for r in recs} == {root.step}
    layers = [i for i, r in enumerate(recs) if r.name == "mamba2.layer"]
    shared = [i for i, r in enumerate(recs) if r.name == "shared.block"]
    assert len(layers) == cfg.n_layers
    assert len(shared) == cfg.n_layers // cfg.shared_attn_every
    assert all(recs[i].parent == 0 for i in layers + shared)
    for i in layers:
        kids = [r.name for r in recs if r.parent == i]
        assert kids == ["mamba2.in_proj", "mamba2.scan", "mamba2.out_proj"]
    assert len(recs) == 1 + 4 * cfg.n_layers + len(shared)


def test_decode_and_training_spans_stay_off():
    """The layer spans run in decode and training too: no-ops there
    unless switched on."""
    from repro_torch.models import forward_decode, forward_train
    from repro_torch.serve import make_prefill_step
    cfg, params, batch = _tiny_hybrid()
    with torch.inference_mode():
        _, cache = make_prefill_step(cfg, torch.bfloat16)(params, batch)
        forward_decode(cfg, params, cache, batch["tokens"][:, :1],
                       batch["tokens"].shape[1] - 1, torch.bfloat16)
    forward_train(cfg, params, {"tokens": batch["tokens"][:, :-1],
                                "targets": batch["tokens"][:, 1:]},
                  torch.bfloat16)
    assert obs.take() == []


def test_mesh_prefill_records_the_same_spans_on_every_rank():
    """The mesh prefill step (two gloo ranks, the SSD heads split over
    'model'): one root a call, the same layer spans under it, and the
    logits bit-equal with the spans on."""
    from torch_ranks import run_ranks
    results = run_ranks(2, "torch_obs_ranks:mesh_prefill_spans",
                        timeout=240)
    for r in results:
        assert r["equal"]
        names = [n for n, _ in r["spans"]]
        assert r["spans"][0] == ("serve.prefill_step", None)
        assert names.count("serve.prefill_step") == 1
        assert names.count("mamba2.layer") == r["n_layers"]
        assert names.count("mamba2.scan") == r["n_layers"]
        assert names.count("shared.block") == r["n_layers"] // r["every"]
    assert results[0]["spans"] == results[1]["spans"]


@pytest.mark.cuda
def test_spans_time_the_card_and_stay_off_its_timeline():
    """On the card: device intervals from the spans' timing events (a
    child inside its parent, on the stream current at entry, a side
    stream's too), and under a profiler tracing the card no span mirrored
    onto its timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the timing events are CUDA's")
    a = torch.randn(2048, 2048, device="cuda")
    side = torch.cuda.Stream()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for _ in range(2):
        with obs.span("serve.prefill_step", a):
            with obs.span("mamba2.in_proj", a):
                for _ in range(20):
                    a @ a
            with torch.cuda.stream(side):
                with obs.span("mamba2.scan", a):
                    a @ a
        torch.cuda.synchronize()
    prof.stop()
    recs = obs.take()
    assert [r.name for r in recs] == 2 * ["serve.prefill_step",
                                          "mamba2.in_proj", "mamba2.scan"]
    root, kid, side_kid = recs[3], recs[4], recs[5]
    assert 0 < kid.device_us <= root.device_us
    assert obs.self_us(recs)[4] == kid.device_us         # a leaf
    assert 0 < side_kid.device_us < kid.device_us    # 1 GEMM against 20
    on_card = {e.name() for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")}
    assert not on_card & {"serve.prefill_step", "mamba2.in_proj",
                          "mamba2.scan"}
    assert on_card                                # the GEMMs were traced
